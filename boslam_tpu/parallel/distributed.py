"""Multi-host runtime bootstrap (SURVEY.md §5.8, §2.3 "Communication
backend"; BASELINE.json >=75%-at-2-hosts scaling target).

The reference's communication backend is Python queues + a lock-protected
shared map on ONE machine (SURVEY.md §2.3).  The JAX equivalent is the
multi-controller runtime: every host runs the same program, calls
``jax.distributed.initialize()``, and afterwards ``jax.devices()`` spans the
whole cluster — meshes built from it (parallel/mesh.make_mesh) get their
``psum``/``all_gather`` collectives from XLA (NCCL on GPUs), with no
hand-written networking (SURVEY.md §5.8).

## Launch recipe

One process per host, all started with the same command:

    # host 0 (also the coordinator)
    BOSLAM_COORDINATOR=host0:8476 BOSLAM_NUM_PROCESSES=2 BOSLAM_PROCESS_ID=0 \
        python -m boslam_tpu.main --tum ... --distributed --global-ba
    # host 1
    BOSLAM_COORDINATOR=host0:8476 BOSLAM_NUM_PROCESSES=2 BOSLAM_PROCESS_ID=1 \
        python -m boslam_tpu.main --tum ... --distributed --global-ba

Under a cluster manager JAX can detect (SLURM, OpenMPI) the three variables
can be omitted (``BOSLAM_DISTRIBUTED=1`` or the CLI ``--distributed`` flag
is enough): ``jax.distributed.initialize()`` reads the coordinator and
process topology from it.

Single-process smoke: initialize(num_processes=1) exercises the same code
path (coordinator service + barrier) without a cluster — this is what the
CI test does (tests/test_parallel.py).
"""

from __future__ import annotations

import os
import sys

import jax

_ENV_COORD = "BOSLAM_COORDINATOR"
_ENV_NPROC = "BOSLAM_NUM_PROCESSES"
_ENV_PID = "BOSLAM_PROCESS_ID"
_ENV_FLAG = "BOSLAM_DISTRIBUTED"

_initialized = False


def maybe_initialize(force: bool = False) -> bool:
    """Initialize the JAX multi-host runtime if requested; idempotent.

    Requested means: ``force=True`` (e.g. the CLI ``--distributed`` flag),
    or any of BOSLAM_COORDINATOR / BOSLAM_DISTRIBUTED=1 set in the
    environment.  With BOSLAM_COORDINATOR set, the explicit
    (coordinator_address, num_processes, process_id) triple is used;
    otherwise ``jax.distributed.initialize()`` auto-detects (SLURM,
    OpenMPI).  Returns True iff the runtime is (now) initialized.  A
    failed initialization raises under ``force=True``; when only the
    environment asked, it is reported and the run stays single-process.
    """
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get(_ENV_COORD)
    flagged = os.environ.get(_ENV_FLAG, "0") not in ("0", "", "false")
    if not (force or coord or flagged):
        return False
    try:
        if coord:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(os.environ.get(_ENV_NPROC, "1")),
                process_id=int(os.environ.get(_ENV_PID, "0")),
            )
        else:
            jax.distributed.initialize()
        _initialized = True
    except Exception as e:
        if force:
            raise
        print(f"[distributed] initialize failed ({e}); "
              "continuing single-process", file=sys.stderr)
        return False
    return True


def is_initialized() -> bool:
    return _initialized


def runtime_info() -> dict:
    """Process/device topology after (maybe) initialization."""
    return {
        "initialized": _initialized,
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
    }
