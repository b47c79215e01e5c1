"""Refpack sharding (refpack.py, served by repeated -f flags) and the
cross-host shard fetch service (shardserver.py).  The device mesh and
multi-host paths of taxtk.parallel are not ported yet."""
