"""Multi-host runtime: distributed init, shard manifests, restartable runs.

The reference is single-process with de-facto stage-level resume through
file materialization (SURVEY.md §5: features .nii.gz, ROIs .ROIInfo, spec
.txt, bags .bag). This module scales that contract out:

  * `distributed_init` wires `jax.distributed.initialize` from standard
    env vars (coordinator address, process count/index) — XLA then owns the
    transport (NCCL between GPUs, gloo between CPU processes).
  * `ShardManifest` records per-block outputs of a sharded run; a restarted
    run skips completed blocks (idempotent-stage model, the reference's
    shell-level-retry pattern made explicit).
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax

from ife_tpu.utils.logging import get_logger

log = get_logger("ife.dist")


def distributed_init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize multi-host JAX. Returns (process_index, process_count).

    Args default from env: IFE_COORDINATOR (host:port), IFE_NUM_PROCESSES,
    IFE_PROCESS_ID (or JAX_PROCESS_INDEX). Single-process if unset.

    One process per host drives all of that host's devices: a GPU host
    runs ONE process over its cards (jax.devices() is every local card),
    never one process per card — several processes on one host would each
    claim every card and each reserve most of every card's memory.
    """
    coordinator = coordinator or os.environ.get("IFE_COORDINATOR")
    if coordinator is None:
        return 0, 1
    # CPU cross-process collectives ride gloo (GPUs: XLA uses NCCL).
    # Decide from the RESOLVED platform list, not just env vars: on a plain
    # CPU-only host with JAX_PLATFORMS unset, JAX still resolves to the cpu
    # backend, and initializing distributed without gloo would make
    # cross-process collectives fail or hang.
    resolved = (os.environ.get("JAX_PLATFORMS", "")
                or (jax.config.jax_platforms or ""))
    if resolved in ("", "cpu") or resolved.startswith("cpu"):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    num_processes = int(
        num_processes or os.environ.get("IFE_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id
        if process_id is not None
        else os.environ.get("IFE_PROCESS_ID", os.environ.get("JAX_PROCESS_INDEX", "0"))
    )
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    os.environ["JAX_PROCESS_INDEX"] = str(process_id)
    log.info(
        "distributed init: process %d/%d, %d local / %d global devices",
        process_id, num_processes,
        jax.local_device_count(), jax.device_count(),
    )
    return process_id, num_processes


def distributed_init_from_args(args) -> Tuple[int, int]:
    """`distributed_init` from CLI flags (--coordinator/--num-processes/
    --process-id), falling back to the IFE_* env vars. The common entry for
    every `--sharded`-capable subcommand."""
    return distributed_init(
        coordinator=getattr(args, "coordinator", None),
        num_processes=getattr(args, "num_processes", None),
        process_id=getattr(args, "process_id", None),
    )


def is_primary() -> bool:
    """True on the process that owns side effects (file writes, logs)."""
    return jax.process_index() == 0


def host_array_to_global(data, mesh) -> jax.Array:
    """Place identical host data (every process holds the full array) onto a
    global mesh sharding. Single-process: plain device_put; multi-process:
    each host donates only its addressable shards
    (`jax.make_array_from_callback` — the standard multi-host ingest
    pattern; device_put cannot target non-addressable devices)."""
    from jax.sharding import NamedSharding

    from ife_tpu.parallel.mesh import volume_pspec

    data = np.asarray(data)
    sharding = NamedSharding(mesh, volume_pspec(mesh))
    if jax.process_count() == 1:
        return jax.device_put(data, sharding)
    return jax.make_array_from_callback(
        data.shape, sharding, lambda idx: data[idx]
    )


def fetch_to_host(arr: jax.Array) -> np.ndarray:
    """Materialize a (possibly multi-host sharded) jax.Array as the full
    numpy array on EVERY process. Single-process or fully-replicated arrays
    transfer directly; cross-host shards ride an allgather
    (`multihost_utils.process_allgather`)."""
    if jax.process_count() == 1 or arr.is_fully_replicated:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


@dataclass
class ShardManifest:
    """Per-block completion ledger for restartable sharded runs.

    JSON file: {"blocks": {block_key: {"path": ..., "done": true}}}.
    Writes are atomic (tmp + rename) so a killed run never corrupts it.
    """

    path: str

    def _load(self) -> Dict:
        if not os.path.exists(self.path):
            return {"blocks": {}}
        with open(self.path) as f:
            return json.load(f)

    def is_done(self, block_key: str) -> bool:
        entry = self._load()["blocks"].get(block_key)
        if not entry or not entry.get("done"):
            return False
        out = entry.get("path")
        return out is None or os.path.exists(out)

    def mark_done(self, block_key: str, out_path: Optional[str] = None) -> None:
        data = self._load()
        data["blocks"][block_key] = {"path": out_path, "done": True}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".manifest.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def pending(self, block_keys: List[str]) -> List[str]:
        return [k for k in block_keys if not self.is_done(k)]

    def reset(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
