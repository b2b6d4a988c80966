"""Dependency-free helpers of the port."""
from .lru import LRUCache

__all__ = ["LRUCache"]
