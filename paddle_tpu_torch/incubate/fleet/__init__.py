"""Fleet distributed-training API (reference:
python/paddle/fluid/incubate/fleet/ — base/fleet_base.py:34): the role
makers and the collective fleet."""
from . import base  # noqa: F401
