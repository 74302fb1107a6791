"""Lint rule registry: importing this package registers every rule with
``repro_torch.analysis.lint`` (rules self-register via ``@rule``)."""
from . import f32accum, hostsync, jitinloop, metricdocs  # noqa: F401
