from .sw import sw_align, OverhangStrategy, SWParams  # noqa: F401
