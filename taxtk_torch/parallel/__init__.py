"""Parallelism: the dp x tp device grid and its classification step
(mesh), the engine's collective pass-0 merge (engine_mesh), multi-host
query sharding (distributed), refpack sharding (refpack) and the
cross-host shard fetch service (shardserver).  Port of taxtk.parallel.

Lazy attribute exports, as in taxtk: `refpack` and `distributed` are
pure IO and stay importable without building a mesh.
"""

__all__ = ["make_mesh", "distributed_classify_step", "dryrun_step"]


def __getattr__(name):
    if name in __all__:
        from . import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
