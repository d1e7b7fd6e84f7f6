"""setup.engine_s: the engine's build and capture in set-up (the program's timed spans ``engine.build`` and ``engine.capture``)."""

from perfbench.spans import setup_engine_s as read

__all__ = ["read"]
