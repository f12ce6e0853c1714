"""Runtime lock-order recorder (``DACP_LOCKCHECK=1``).

Patches ``threading.Lock``/``RLock``/``Condition`` so every lock *created
by repro_torch code* (a frame whose file lies under ``/repro_torch/``) is
tracked: each thread keeps a stack of held locks, and
acquiring B while A is held records the edge ``A -> B`` under the same
canonical node names the static analyzer uses (``ClassName.attr`` for
``self.X = threading.Lock()`` sites, ``stem.func.var`` for function
locals, ``stem.var`` at module level).  Two instances of the *same* named
lock held together are recorded separately as a cross-instance hazard.

At process exit the observed graph is dumped to ``DACP_LOCKCHECK_OUT``
(unioned with any existing file, so a multi-process test run
accumulates).  CI feeds the dump to
``python -m tools.dacpcheck --runtime-graph`` which unions it with the
static graph before cycle detection.

Locks created outside repro_torch frames (stdlib ``queue.Queue`` internals,
pytest, logging) pass through untracked, so overhead lands only on the
locks we care about.
"""

from __future__ import annotations

import atexit
import json
import linecache
import os
import re
import sys
import threading

from repro_torch.core.env import env_bool, env_str

_ATTR_RE = re.compile(r"self\.(\w+)\s*[:=]")
_VAR_RE = re.compile(r"(\w+)\s*[:=]")

_state = threading.local()
_edges: set = set()
_cross: set = set()
_graph_lock = threading.Lock()
_installed = False
_orig = {}


def _held():
    st = getattr(_state, "held", None)
    if st is None:
        st = _state.held = []
    return st


def _note_acquire(tracked) -> None:
    held = _held()
    for h in held:
        if h is tracked:
            return  # reentrant re-acquire of the same instance: no new edges
    new_edges = []
    new_cross = []
    for h in held:
        if h.dacp_name == tracked.dacp_name:
            new_cross.append((h.dacp_name, tracked.dacp_name))
        else:
            new_edges.append((h.dacp_name, tracked.dacp_name))
    held.append(tracked)
    if new_edges or new_cross:
        with _graph_lock:
            _edges.update(new_edges)
            _cross.update(new_cross)


def _note_release(tracked) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is tracked:
            del held[i]
            return


def _name_from_frame(frame, kind: str) -> str:
    line = linecache.getline(frame.f_code.co_filename, frame.f_lineno)
    self_obj = frame.f_locals.get("self")
    if self_obj is not None:
        m = _ATTR_RE.search(line)
        if m:
            return f"{type(self_obj).__name__}.{m.group(1)}"
    stem = os.path.splitext(os.path.basename(frame.f_code.co_filename))[0]
    m = _VAR_RE.search(line)
    var = m.group(1) if m else f"anon_{kind}"
    if frame.f_code.co_name == "<module>":
        return f"{stem}.{var}"
    return f"{stem}.{frame.f_code.co_name}.{var}"


def _repro_frame(frame) -> bool:
    fn = frame.f_code.co_filename.replace("\\", "/")
    return "/repro_torch/" in fn and "/tools/" not in fn


class _TrackedLock:
    def __init__(self, inner, name: str):
        self._inner = inner
        self.dacp_name = name

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            _note_acquire(self)
        return got

    def release(self):
        _note_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<tracked {self.dacp_name} {self._inner!r}>"


class _TrackedCondition:
    def __init__(self, inner, name: str):
        self._inner = inner
        self.dacp_name = name

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            _note_acquire(self)
        return got

    def release(self):
        _note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout=None):
        # the underlying lock is released for the duration of the wait
        _note_release(self)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_acquire(self)

    def wait_for(self, predicate, timeout=None):
        _note_release(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _note_acquire(self)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def __repr__(self):
        return f"<tracked {self.dacp_name} {self._inner!r}>"


def _factory(orig, kind: str):
    def make(*args, **kwargs):
        frame = sys._getframe(1)
        if not _repro_frame(frame):
            return orig(*args, **kwargs)
        name = _name_from_frame(frame, kind)
        if kind == "cond":
            # unwrap a tracked lock handed to Condition(lock): the condition
            # node subsumes it for ordering purposes
            if args and isinstance(args[0], (_TrackedLock,)):
                args = (args[0]._inner,) + args[1:]
            lk = kwargs.get("lock")
            if isinstance(lk, _TrackedLock):
                kwargs["lock"] = lk._inner
            return _TrackedCondition(orig(*args, **kwargs), name)
        return _TrackedLock(orig(*args, **kwargs), name)

    return make


def observed() -> dict:
    with _graph_lock:
        return {
            "edges": sorted([a, b] for a, b in _edges),
            "cross_instance": sorted([a, b] for a, b in _cross),
        }


def dump(path: str | None = None) -> str:
    path = path or env_str("DACP_LOCKCHECK_OUT")
    data = observed()
    try:
        with open(path, encoding="utf-8") as f:
            prior = json.load(f)
        data["edges"] = sorted({tuple(e) for e in prior.get("edges", [])} | {tuple(e) for e in data["edges"]})
        data["cross_instance"] = sorted(
            {tuple(e) for e in prior.get("cross_instance", [])} | {tuple(e) for e in data["cross_instance"]})
        data["edges"] = [list(e) for e in data["edges"]]
        data["cross_instance"] = [list(e) for e in data["cross_instance"]]
    except (OSError, ValueError):
        pass
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, path)
    return path


def install(out_path: str | None = None) -> bool:
    """Patch the threading factories; returns True if newly installed."""
    global _installed
    if _installed:
        return False
    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    _orig["Condition"] = threading.Condition
    threading.Lock = _factory(_orig["Lock"], "lock")
    threading.RLock = _factory(_orig["RLock"], "rlock")
    threading.Condition = _factory(_orig["Condition"], "cond")
    _installed = True

    def _dump_at_exit():
        try:
            dump(out_path)
        except OSError:
            pass  # out dir may be gone by interpreter teardown (tmp paths)

    atexit.register(_dump_at_exit)
    return True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _orig["Lock"]
    threading.RLock = _orig["RLock"]
    threading.Condition = _orig["Condition"]
    _installed = False


def install_if_enabled() -> bool:
    if env_bool("DACP_LOCKCHECK"):
        return install()
    return False
