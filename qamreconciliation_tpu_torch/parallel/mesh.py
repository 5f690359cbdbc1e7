"""Rank meshes on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py``: one process (a
rank) per device of a 1-D mesh.  Each rank runs a full batch of frames,
and the sweep counters are summed over the ranks (frame-shard data
parallelism), or the ranks split one code's Tanner graph
(``parallel/graph_shard.py``).

Rank ``r`` runs on ``cuda:(r % torch.cuda.device_count())``, or on the CPU.
The process group's backend follows one rule, printed when the group
starts: NCCL when every rank has a card of its own, gloo when ranks share
a card or run on the CPU.  The ranks come from a launcher (``torchrun``
sets ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``;
:func:`maybe_distributed_init` joins its group) or from :func:`run_ranks`,
which starts them as processes of its own and joins them through a file
store in a temporary directory.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import warnings

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "device_count", "maybe_distributed_init",
           "backend_for", "run_ranks", "LAUNCHER_VARS"]

# what a launcher sets for the ranks it starts
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
# seconds a collective may wait for the other ranks before it raises
COLLECTIVE_TIMEOUT = 600


def device_count() -> int:
    """The cards on this host (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def backend_for(world: int, device="cuda") -> str:
    """"nccl" when ``world`` ranks on ``device`` each have a card of their
    own on the host, else "gloo" (ranks that share a card, or the CPU)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda" and device_count() >= local:
        return "nccl"
    return "gloo"


def _rank_device(rank: int, device) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % cards)`` for a CUDA
    ``device``, made the current one, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs CUDA, which is not available")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _announce(backend: str, device) -> None:
    rank, world = dist.get_rank(), dist.get_world_size()
    print(f"[mesh] rank {rank}/{world}: backend {backend}, device "
          f"{_rank_device(rank, device)}", file=sys.stderr, flush=True)


def maybe_distributed_init(verbose: bool = True, device="cuda") -> bool:
    """Join the process group of a launcher's ranks.

    Every sweep CLI calls this before any device use.  It is a no-op that
    returns False when no launcher set ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``, and returns True when the group is (or already was)
    up.  The backend follows :func:`backend_for` for ``device``.  A failed
    init warns loudly with a ``RuntimeWarning`` and returns False, so the
    caller never counts one rank's frames as the whole mesh's in silence.
    """
    if dist.is_initialized():
        return True
    if not all(v in os.environ for v in LAUNCHER_VARS):
        return False
    backend = backend_for(int(os.environ["WORLD_SIZE"]), device)
    try:
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    except (RuntimeError, ValueError, OSError) as e:
        warnings.warn(
            "a launcher set RANK/WORLD_SIZE/MASTER_ADDR but "
            f"torch.distributed.init_process_group({backend!r}) failed: "
            f"{e!r}; FALLING BACK to a single rank, whose counters cover "
            "only its own frames",
            RuntimeWarning, stacklevel=2,
        )
        return False
    if verbose:
        _announce(backend, device)
    return True


class Mesh:
    """A 1-D mesh of ranks: the process group (None for a single rank),
    this rank, the world size, this rank's device and the axis name.

    The collectives run along the axis on tensors on ``device``, every
    rank issuing the same calls in the same order: :meth:`all_reduce_sum`,
    :meth:`all_gather` and the point-to-point :meth:`exchange`.  A failed
    collective raises.  ``stage_host`` is decided here, from the backend,
    once: gloo's point-to-point refuses CUDA tensors (its send writes from
    the device pointer: "writev ... Bad address", raised or aborting the
    process, in ``chip_smoke.py`` phase 16's probe on the H100), so under
    gloo a CUDA rank's exchange goes through pinned host buffers, and
    NCCL's takes the CUDA tensors directly.
    """

    def __init__(self, group, rank: int, world: int, device,
                 axis_name: str, backend: str | None):
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.axis_name = axis_name
        self.backend = backend
        self.stage_host = backend == "gloo" and self.device.type == "cuda"

    def __repr__(self):
        return (f"Mesh({self.axis_name!r}: rank {self.rank}/{self.world}, "
                f"{self.device}, {self.backend})")

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place; returns ``x``."""
        if self.world > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, stacked in rank order: ``[world, *x.shape]``
        in ``x``'s dtype, bit for bit (signed zeros and NaNs included): the
        collective moves ``x``'s raw bytes, whatever its dtype, with
        ``all_gather`` into the rows of one buffer on every backend (gloo
        gathers CUDA tensors exactly, staged through the host: checked on
        the H100 by ``chip_smoke.py`` phase 16)."""
        x = x.contiguous()
        if self.world == 1:
            return x.unsqueeze(0).clone()
        raw = x.reshape(-1).view(torch.uint8)
        buf = torch.empty((self.world, raw.numel()), dtype=torch.uint8,
                          device=x.device)
        dist.all_gather(list(buf.unbind(0)), raw, group=self.group)
        return buf.view(x.dtype).view(self.world, *x.shape)

    def exchange(self, sends: dict, recv_shapes: dict, dtype) -> dict:
        """Point to point: ``sends[q]`` to peer q, and from each peer q in
        ``recv_shapes`` one tensor of that shape; returns {q: received}.

        Every rank posts its operations in the same order (peers
        ascending, for each its send, then its receive) with
        ``dist.batch_isend_irecv`` and waits for all of them.  Raw bytes
        move, whatever ``dtype``, so bf16, signed zeros and NaNs arrive bit
        for bit; with ``stage_host`` through pinned host buffers.  What a
        rank receives must be what its peer sends it, in size and dtype;
        a failed transfer raises."""
        if self.rank in sends or self.rank in recv_shapes:
            raise ValueError(f"rank {self.rank} cannot exchange with itself")
        out = {q: torch.empty(shape, dtype=dtype, device=self.device)
               for q, shape in recv_shapes.items()}
        ops, landed = [], []
        for q in sorted(set(sends) | set(out)):
            if q in sends:
                if sends[q].dtype != dtype:
                    raise ValueError(f"a {sends[q].dtype} send among "
                                     f"{dtype} exchanges")
                raw = sends[q].contiguous().reshape(-1).view(torch.uint8)
                if self.stage_host:
                    raw = torch.empty(raw.numel(), dtype=torch.uint8,
                                      pin_memory=True).copy_(raw)
                ops.append(dist.P2POp(dist.isend, raw, q, self.group))
            if q in out:
                raw = out[q].reshape(-1).view(torch.uint8)
                if self.stage_host:
                    host = torch.empty(raw.numel(), dtype=torch.uint8,
                                       pin_memory=True)
                    landed.append((raw, host))
                    raw = host
                ops.append(dist.P2POp(dist.irecv, raw, q, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for dst, host in landed:
            dst.copy_(host)
        return out

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.group)


def make_mesh(n_devices: int | None = None, axis_name: str = "dp",
              device="cuda") -> Mesh:
    """The 1-D mesh of the running ranks.

    Inside a process group (a launcher's, or :func:`run_ranks`'s) the mesh
    spans all its ranks, and ``n_devices``, when given, must equal its
    world size.  Without one, ``n_devices`` None or 1 gives a single-rank
    mesh; more ranks need a group, so that raises.  Rank r's device is
    ``cuda:(r % cards)`` for a CUDA ``device`` (made the current device),
    else ``device``.
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(f"a mesh of {n_devices} devices, but the "
                             f"process group has {world} ranks")
        group, backend = dist.group.WORLD, dist.get_backend()
        if backend == "nccl" and torch.device(device).type != "cuda":
            raise ValueError("an NCCL process group needs CUDA devices")
    elif n_devices is None or int(n_devices) == 1:
        world, rank, group, backend = 1, 0, None, None
    else:
        raise RuntimeError(
            f"a mesh of {n_devices} devices needs a process group of as "
            "many ranks: start them with parallel.mesh.run_ranks, or with "
            "a launcher such as torchrun")
    return Mesh(group, rank, world, _rank_device(rank, device), axis_name,
                backend)


def _rank_main(rank, world, store, device, timeout, out_dir, fn, args):
    """One rank started by :func:`run_ranks`: join the group through the
    file store, run ``fn(*args)``, write its result for the parent.

    A rank whose result is written leaves by ``os._exit(0)`` once its group
    is destroyed, past the interpreter's teardown: there torch's static
    state is destroyed, and on gloo under CPU load that now and then aborts
    the rank ("terminate called without an active exception", exit code
    -6) after its work is done."""
    backend = backend_for(world, device)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        _announce(backend, device)
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(fn, world: int, args=(), device="cuda",
              timeout: float = COLLECTIVE_TIMEOUT) -> list:
    """Run ``fn(*args)`` on ``world`` ranks started here and return their
    results in rank order.

    Each rank is a process started with ``torch.multiprocessing``'s spawn
    method, so ``fn`` and ``args`` travel by pickle (``fn`` by its import
    path) and the results must be picklable (host values, not CUDA
    tensors).  The ranks join one group through a file store in a
    temporary directory, with :func:`backend_for`'s backend for
    ``device``.  A rank that fails stops the others and raises
    ``RuntimeError``; ranks still running after ``timeout`` seconds are
    stopped and raise ``TimeoutError``, as does a collective that waits
    that long.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="qam-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, store, str(device), timeout, tmp, fn, tuple(args)))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(
                        f"rank {failed[0]} of {world} exited with code "
                        f"{procs[failed[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"rank {failed[0]} of {world} exited with "
                               f"code {procs[failed[0]].exitcode}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
