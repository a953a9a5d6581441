"""Headless PySide6-compatible shim.

PySide6 is a heavyweight optional dependency that is frequently absent
(CI containers, the card's machine, this package's test hosts).  This
package implements the *exact Qt API subset the app uses* — signals/slots,
the widget tree, dialogs, pixmaps, timers, the thread pool — with
pure-Python state and deterministic synchronous semantics:

  * ``QThreadPool.start`` runs the runnable synchronously,
  * ``QTimer.start`` fires ``timeout`` immediately (debounces collapse),
  * static dialogs return inert defaults and are monkeypatchable,

so every screen of ``ui.qt_app`` can be constructed, wired, click-driven,
and torn down in pytest with no display server.  It is NOT a rendering
replacement — with real PySide6 installed the app prefers it (see
``qt_app``'s import order) and this shim never loads.

Activate explicitly::

    from softspoken_tpu_torch.ui.qt_shim import install
    install()            # idempotent; no-op if real PySide6 importable
    import softspoken_tpu_torch.ui.qt_app   # now runs headless

or set ``SOFTSPOKEN_QT_SHIM=1`` before importing ``qt_app``.

Another headless shim that installs itself as the top-level ``PySide6``
(the JAX package carries one) may already be in the process: ``install``
then puts this package's own ``PySide6`` in its place, and checks by file
that ``import PySide6`` resolves here.
"""

from __future__ import annotations

import importlib
import os
import sys

SHIM_DIR = os.path.dirname(os.path.abspath(__file__))


def have_real_pyside6() -> bool:
    try:
        import PySide6  # noqa: F401

        return not getattr(PySide6, "__softspoken_shim__", False)
    except Exception:  # noqa: BLE001
        return False


def _installed() -> bool:
    """Whether ``import PySide6`` gives this package's shim."""
    mod = sys.modules.get("PySide6")
    return mod is not None and os.path.dirname(
        os.path.dirname(os.path.abspath(getattr(mod, "__file__", "") or ""))) == SHIM_DIR


def install(force: bool = False) -> bool:
    """Make ``import PySide6`` resolve to this shim. Returns True if the shim
    is active (False when real PySide6 is present and ``force`` is off)."""
    if _installed():
        return True
    if not force and have_real_pyside6():
        return False
    # first on the path, ahead of any other shim's directory
    while SHIM_DIR in sys.path:
        sys.path.remove(SHIM_DIR)
    sys.path.insert(0, SHIM_DIR)
    # drop a partially-imported PySide6 or another shim's, if any
    for mod in [m for m in sys.modules if m == "PySide6" or m.startswith("PySide6.")]:
        del sys.modules[mod]
    importlib.invalidate_caches()
    importlib.import_module("PySide6")
    if not _installed():
        raise ImportError(f"PySide6 resolved to {sys.modules['PySide6'].__file__}, "
                          f"not to the shim in {SHIM_DIR}")
    return True
