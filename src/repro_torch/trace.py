"""Spans of the COOK path: one recorder for the process, off by default.

A span site reads ``ON`` and, while it is False, does nothing more: no
clock read, no allocation::

    sp = trace.ON and trace.begin("merge", request_id, leaf=True)
    total.merge(st)
    if sp:
        trace.finish(sp)

While on, each closed span keeps its name, its start and end on
``time.perf_counter_ns``, its thread's CPU time at both ends
(``time.thread_time_ns``), its thread, its parent span and its request id
(``ExecutorStats.request_id``, one per COOK).  A span's parent is the span
open on its own thread when it opened; a span that opens on a thread with
none open (a worker's morsel, the prefetch thread's source batch) takes the
request's innermost *root*: the ``cook`` span, opened ``detached`` because
it starts on one thread and may end on another, or the ``request`` span once
``adopt`` has given it its request id.  A span opened without a request id
takes its parent's.

The recorder turns on with ``enable()``, and by itself while a
``torch.profiler`` session records in this process: ``follow_profiler()``,
called once per COOK request, turns it on at the first request of a session
and off at the first request after it.  ``disable()`` turns it off and
returns the ``Recording``.

Clock: ``torch.profiler`` stamps its events in Unix time.  Every ``enable``,
``disable`` and ``follow_profiler`` call while on adds a clock sample
(``perf_counter_ns`` before, ``time_ns``, ``perf_counter_ns`` after), from
which a reader puts each span on the profiler's clock and sees how far the
samples disagree.

Leaf spans (no span opens inside them) also open a
``record_function("dacp.<name>")`` range when ``enable()`` found a profiler
recording on its own thread; the profiler records such ranges only on the
thread that started it.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

ON = False  # read by every span site

MAX_SPANS = 1 << 21  # spans kept; later ones are counted in ``dropped``

# an open span: [name, start ns, cpu start ns, thread, id, parent id, request id, detached, root, record_function]
_NAME, _START, _CPU, _THREAD, _ID, _PARENT, _REQUEST, _DETACHED, _ROOT, _RANGE = range(10)


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    cpu_start_ns: int | None  # time.thread_time_ns; None for a span that ended on another thread
    cpu_end_ns: int | None
    thread: int
    span_id: int
    parent: int | None
    request: int | None


class Recording(NamedTuple):
    spans: list  # [Span], in the order they closed
    clock: list  # [(perf_counter_ns before, time_ns, perf_counter_ns after)]: first at the start, last at the end
    dropped: int  # spans past MAX_SPANS


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []


_local = _Local()
_lock = threading.Lock()
_ids = itertools.count(1)
_roots: dict = {}  # request id -> (open root spans, innermost last); replaced whole, under _lock
_spans: list = []  # closed spans as plain tuples, Span's fields
_clock: list = []
_dropped = 0
_bridge = False  # leaf spans open record_function ranges
_following = False  # on because a profiler records


def _sample() -> None:
    a = time.perf_counter_ns()
    unix = time.time_ns()
    _clock.append((a, unix, time.perf_counter_ns()))


def enable() -> None:
    """Start a new recording (dropping any not yet taken)."""
    global ON, _spans, _clock, _dropped, _bridge, _following
    with _lock:
        _roots.clear()
    _spans, _clock, _dropped = [], [], 0
    _bridge = torch.autograd._profiler_enabled()
    _following = False
    _sample()
    ON = True


def disable() -> Recording:
    """Stop recording and hand over what was recorded since ``enable``."""
    global ON, _spans, _clock, _dropped, _following
    if ON:
        ON = False
        _sample()
    _following = False
    rec = Recording([Span._make(s) for s in _spans], _clock, _dropped)
    _spans, _clock, _dropped = [], [], 0
    return rec


def follow_profiler() -> None:
    """Turn the recorder on while a ``torch.profiler`` session records in
    the process, and off once it has stopped (the spans wait for
    ``disable``).  An ``enable()`` without a profiler is left alone."""
    global ON, _following
    recording = getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    if recording and not ON:
        enable()
        _following = True
    elif ON and _following:
        if not recording:
            ON = False
            _following = False
        _sample()


def begin(name: str, request: int | None = None, start: int | None = None, leaf: bool = False,
          detached: bool = False) -> list:
    """Open a span (``start``: a ``perf_counter_ns`` reading the caller took
    already).  ``detached``: a root of its request, kept off the thread's
    stack."""
    stack = _local.stack
    if stack and not detached:
        top = stack[-1]
        parent = top[_ID]
        if request is None:
            request = top[_REQUEST]
    else:
        roots = _roots.get(request)
        parent = roots[-1][_ID] if roots else None
    sp = [name, 0, 0, threading.get_ident(), next(_ids), parent, request, detached, detached, None]
    if detached:
        _add_root(sp)
    else:
        stack.append(sp)
    sp[_START] = time.perf_counter_ns() if start is None else start
    sp[_CPU] = time.thread_time_ns()
    if leaf and _bridge:
        sp[_RANGE] = torch.autograd.profiler.record_function("dacp." + name)
        sp[_RANGE].__enter__()
    return sp


def adopt(sp: list, request: int) -> None:
    """Give an open span the request id it learned after it opened, and make
    it the request's root."""
    sp[_REQUEST] = request
    sp[_ROOT] = True
    _add_root(sp)


def _add_root(sp: list) -> None:
    with _lock:
        _roots[sp[_REQUEST]] = _roots.get(sp[_REQUEST], ()) + (sp,)


def finish(sp: list, end: int | None = None) -> None:
    """Close a span (``end``: a ``perf_counter_ns`` reading the caller took
    already).  Spans left open above it on its thread are dropped."""
    global _dropped
    if sp[_RANGE] is not None:
        sp[_RANGE].__exit__(None, None, None)
    end = time.perf_counter_ns() if end is None else end
    cpu_end = time.thread_time_ns()
    same_thread = threading.get_ident() == sp[_THREAD]
    if same_thread and not sp[_DETACHED]:
        stack = _local.stack
        if stack and stack[-1] is sp:
            stack.pop()
        elif any(s is sp for s in stack):
            while stack.pop() is not sp:
                pass
    if sp[_ROOT]:
        with _lock:
            roots = tuple(s for s in _roots.get(sp[_REQUEST], ()) if s is not sp)
            if roots:
                _roots[sp[_REQUEST]] = roots
            else:
                _roots.pop(sp[_REQUEST], None)
    if len(_spans) >= MAX_SPANS:
        _dropped += 1
        return
    cpu_start = sp[_CPU] if same_thread else None
    _spans.append((sp[_NAME], sp[_START], end, cpu_start, cpu_end if same_thread else None, sp[_THREAD], sp[_ID],
                   sp[_PARENT], sp[_REQUEST]))
