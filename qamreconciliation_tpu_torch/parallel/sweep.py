"""Sharded Monte-Carlo rounds: frame-shard data parallelism with summed
counters.

The counterpart of the JAX package's ``parallel/sweep.py``: each rank of
a 1-D mesh runs an independent batch of frames and the four sweep counters
are summed over the ranks with one all-reduce.

The generator rule: round ``k`` of a point seeded ``s`` draws on rank ``r``
from ``np.random.SeedSequence([s, k, r])``
(``sims.engine.round_generator(s, k, device, rank=r)``), and on a single
device without a mesh from ``SeedSequence([s, k])``.  The JAX package folds
the round's key with the mesh axis index, whose streams torch cannot
reproduce; this rule keeps the ranks decorrelated and every rank's frames
reproducible, whatever the world size.
"""

from __future__ import annotations

from ..sims.engine import point_seed, seeded_dispatches

__all__ = ["shard_round", "sharded_sweep"]


def shard_round(round_fn, mesh, axis_name: str = "dp"):
    """A mesh-wide round from a per-rank one.

    ``round_fn(generator, *args) -> counters`` (a ``[4]`` int64 tensor for
    the engines, or any tensor of counts) runs on every rank with that
    rank's generator for the round; the returned ``fn(seed, k, *args)``
    runs round ``k`` of a point seeded ``seed`` and returns the counters
    summed over the ranks, the same on every rank.
    """
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's axis "
                         f"{mesh.axis_name!r}")

    def sharded(seed, k, *args):
        return seeded_dispatches(lambda gen: round_fn(gen, *args), seed, 1,
                                 mesh.device, mesh)(k)

    return sharded


def sharded_sweep(engine, mode, snr_points, mesh, axis_name="dp",
                  **point_kw):
    """Run an SNR sweep with frames sharded over ``mesh``; returns a list of
    ``PointResult``.  ``engine`` must have been built with
    ``mesh_axis=(mesh, axis_name)``, so its rounds sum their counters over
    the ranks.  Point ``i`` is seeded ``seed + 1000003 * i`` (``seed`` from
    ``point_kw``, default 0), as the CLIs seed their points."""
    if engine.mesh is not mesh or axis_name != mesh.axis_name:
        raise ValueError("the engine was not built with mesh_axis=(mesh, "
                         f"{axis_name!r})")
    kw = dict(point_kw)
    seed = kw.pop("seed", 0)
    return [engine.run_point(mode, float(snr), seed=point_seed(seed, i), **kw)
            for i, snr in enumerate(snr_points)]
