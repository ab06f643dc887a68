"""Warn-once `DeprecationWarning` helper for the v1 shim surface.

Every deprecated entry point calls `warn_once(<its name>, <replacement>)`:
the first call per process emits a single `DeprecationWarning`, later calls
are silent.  Tests that assert the exactly-once contract use `reset()` to
rearm a name.  The registry is the port's own, apart from the JAX
package's.
"""

from __future__ import annotations

import warnings

_WARNED: set[str] = set()


def warn_once(name: str, alternative: str) -> None:
    """Emit `DeprecationWarning` for `name` once per process."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(f"{name} is deprecated; use {alternative} instead",
                  DeprecationWarning, stacklevel=3)


def reset(name: str | None = None) -> None:
    """Rearm one deprecated name (or all of them) — test hygiene only."""
    if name is None:
        _WARNED.clear()
    else:
        _WARNED.discard(name)
