"""SE(3) / quaternion geometry, fully batched jnp.

Replacement for the Lie-group machinery the reference obtains from
g2o's ``VertexSE3Expmap`` / ``SE3Quat`` C++ types (SURVEY.md §2.2).  Poses are
stored as flat ``[..., 7]`` arrays ``(qw, qx, qy, qz, tx, ty, tz)`` (Hamilton
convention, unit quaternion) so the whole map is a dense array; conversions to
rotation matrices happen on the fly inside kernels.

Convention: a pose ``T`` acts on points as ``x' = R x + t``.  The SLAM engine
stores camera poses as ``T_cw`` (world -> camera), matching ORB-SLAM.

Twist (tangent) vectors are ``[..., 6] = (omega[3], v[3])`` with rotation
first; ``exp``/``log`` use the exact closed forms with Taylor fallbacks for
small angles so they are safe under ``jax.grad``.
"""

from __future__ import annotations

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Quaternions (Hamilton, w-first)
# ---------------------------------------------------------------------------


def quat_identity(shape=()):
    q = jnp.zeros(shape + (4,))
    return q.at[..., 0].set(1.0)


def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def quat_mul(a, b):
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q, v):
    """Rotate vectors ``v[..., 3]`` by unit quaternions ``q[..., 4]``."""
    qv = q[..., 1:]
    qw = q[..., :1]
    uv = jnp.cross(qv, v)
    uuv = jnp.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_mat(q):
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """Rotation matrix -> unit quaternion, branchless (Shepperd's method)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate quaternions (unnormalized), one per dominant component.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], axis=-1)
    cases = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4, 4]
    scores = jnp.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1
    )
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cases, idx[..., None, None].repeat(4, -1), axis=-2)
    q = q[..., 0, :]
    q = quat_normalize(q)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(omega):
    """Rotation vector [..., 3] -> unit quaternion.

    Uses the safe-where pattern (substitute a benign value inside the unused
    branch) so gradients at omega -> 0 are finite under jax.grad.
    """
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    small = theta2 < 1e-12
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    half = 0.5 * theta
    # sin(theta/2)/theta with Taylor fallback.
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([w, k * omega], axis=-1))


def so3_log(q):
    """Unit quaternion -> rotation vector [..., 3]."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 => theta in [0, pi]
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vn2 = jnp.sum(q[..., 1:] ** 2, axis=-1, keepdims=True)
    small = vn2 < 1e-16
    vn = jnp.sqrt(jnp.where(small, 1.0, vn2))
    theta = 2.0 * jnp.arctan2(vn, w)
    k = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), theta / vn)
    return k * q[..., 1:]


def hat(v):
    """Skew-symmetric matrix of [..., 3]."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE(3) poses as [..., 7] = (q, t)
# ---------------------------------------------------------------------------


def pose_identity(shape=()):
    p = jnp.zeros(shape + (7,))
    return p.at[..., 0].set(1.0)


def make_pose(q, t):
    return jnp.concatenate([q, t], axis=-1)


def rotation(p):
    return p[..., :4]


def translation(p):
    return p[..., 4:]


def pose_apply(p, x):
    """Apply pose(s) to points ``x[..., 3]``: R x + t."""
    return quat_rotate(p[..., :4], x) + p[..., 4:]


def pose_compose(a, b):
    """(a ∘ b)(x) = a(b(x))."""
    q = quat_mul(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:]) + a[..., 4:]
    return make_pose(quat_normalize(q), t)


def pose_inv(p):
    qi = quat_conj(p[..., :4])
    return make_pose(qi, -quat_rotate(qi, p[..., 4:]))


def pose_to_mat(p):
    """[..., 7] -> homogeneous [..., 4, 4]."""
    m = jnp.zeros(p.shape[:-1] + (4, 4))
    m = m.at[..., :3, :3].set(quat_to_mat(p[..., :4]))
    m = m.at[..., :3, 3].set(p[..., 4:])
    return m.at[..., 3, 3].set(1.0)


def mat_to_pose(m):
    return make_pose(mat_to_quat(m[..., :3, :3]), m[..., :3, 3])


def _so3_left_jacobian(omega):
    """V(omega) such that exp(omega, v) has translation V v."""
    theta2 = jnp.sum(omega * omega, axis=-1)[..., None, None]
    small = theta2 < 1e-12
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    W = hat(omega)
    W2 = W @ W
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    b = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2_safe * theta),
    )
    eye = jnp.broadcast_to(jnp.eye(3), W.shape)
    return eye + a * W + b * W2


def _so3_left_jacobian_inv(omega):
    theta2 = jnp.sum(omega * omega, axis=-1)[..., None, None]
    small = theta2 < 1e-12
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    W = hat(omega)
    W2 = W @ W
    # 1/theta^2 - (1+cos)/(2 theta sin); sin(theta) == 0 only at theta ~ pi
    # (theta in [0, pi] from so3_log) where the formula is still finite.
    sin_safe = jnp.where(jnp.abs(jnp.sin(theta)) < 1e-7, 1e-7, jnp.sin(theta))
    cot = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / theta2_safe - (1.0 + jnp.cos(theta)) / (2.0 * theta * sin_safe),
    )
    eye = jnp.broadcast_to(jnp.eye(3), W.shape)
    return eye - 0.5 * W + cot * W2


def exp(xi):
    """se(3) twist ``[..., 6] = (omega, v)`` -> pose [..., 7]."""
    omega, v = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(omega)
    V = _so3_left_jacobian(omega)
    t = jnp.einsum("...ij,...j->...i", V, v)
    return make_pose(q, t)


def log(p):
    """Pose [..., 7] -> twist [..., 6] = (omega, v)."""
    omega = so3_log(p[..., :4])
    Vinv = _so3_left_jacobian_inv(omega)
    v = jnp.einsum("...ij,...j->...i", Vinv, p[..., 4:])
    return jnp.concatenate([omega, v], axis=-1)


def retract(p, xi):
    """Left-multiplicative update: exp(xi) ∘ p  (the GN/LM pose update)."""
    return pose_compose(exp(xi), p)


def pose_distance(a, b):
    """(rotation angle [rad], translation distance) between two poses."""
    d = pose_compose(pose_inv(a), b)
    return jnp.linalg.norm(so3_log(d[..., :4]), axis=-1), jnp.linalg.norm(
        d[..., 4:], axis=-1
    )
