"""Incubating front-ends (reference: python/paddle/fluid/incubate/): the
collective Fleet. The parameter-server fleets, the data generators and
the fleet utilities are not ported (ROADMAP.md Queue 1 item 9)."""
from . import fleet  # noqa: F401
