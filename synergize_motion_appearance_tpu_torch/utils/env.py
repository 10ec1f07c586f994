"""Strict environment-flag parsing (the port's copy of the JAX package's
utils/env.py).

A flag is unset (None), strictly true ({1, true, yes, on}) or strictly
false ({0, false, no, off, ""}), case and surrounding blanks ignored;
anything else raises, so that a typo fails loudly instead of flipping a
feature.
"""
from __future__ import annotations

import os
from typing import Optional

_ENV_TRUE = ("1", "true", "yes", "on")
_ENV_FALSE = ("0", "false", "no", "off", "")


def env_flag(name: str) -> Optional[bool]:
    """Tri-state flag: None when unset, else a strictly parsed bool."""
    raw = os.environ.get(name)
    if raw is None:
        return None
    v = raw.strip().lower()
    if v in _ENV_TRUE:
        return True
    if v in _ENV_FALSE:
        return False
    raise ValueError(
        f"{name}={raw!r}: expected one of {_ENV_TRUE + _ENV_FALSE}")


def env_flag_default(name: str, default: bool) -> bool:
    """``env_flag`` with ``default`` when the flag is unset."""
    v = env_flag(name)
    return default if v is None else v
