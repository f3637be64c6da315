from . import lib  # noqa: F401
