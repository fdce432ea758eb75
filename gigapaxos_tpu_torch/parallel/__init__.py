"""The sharded data plane: a (replica, groups) mesh of torch devices and
the tick run as one body per shard (``mesh.py``, ``shard_tick.py``)."""
