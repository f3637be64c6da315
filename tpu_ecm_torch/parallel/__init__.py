"""Splitting the curve axis over several devices of one host (mesh), and
running one job across hosts (distributed) with a stop-on-factor flag
(coordination): the twin of tpu_ecm/parallel."""

from .mesh import Sharder  # noqa: F401
from . import coordination  # noqa: F401
from . import distributed  # noqa: F401
