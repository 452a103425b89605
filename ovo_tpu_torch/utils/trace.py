"""Spans and counters of the program, on the profiler's clock.

``span(name)`` marks a stage of the work on the host, ``wait(name)`` a
blocking host read of a device value (its name is ``wait.<name>``),
``count`` and ``gauge`` record counters. They record only while a
``torch.profiler`` runs in the process (a window: the first span recorded
after the recorder saw the profiler off, or after :func:`records` read a
closed window, clears the last window's records), and otherwise cost one
attribute read: no clock, no allocation. Recording reads the host clock
and appends; it never touches the card.

A span's times are ``time.time_ns``, the clock of a Chrome trace's
``ts * 1e3 + baseTimeNanoseconds``, so program spans and device events
share one timeline (:func:`export_chrome`). A span's ``frame_id`` is the
keyframe its work serves (inherited from the enclosing span when not
given); a micro-batch's span carries the batch's first frame id and
``n_kf`` the batch size.

``keep=True`` also times a span outside a window and keeps the newest of
its name for :func:`last_seconds`, for ``semantic.log``'s per-keyframe
stats: one record per name, so a long logged run holds bounded memory.

Span names by layer (``README.md``, "profile_trace"): ``step``,
``loop.data_wait``, ``data.read``, ``backbone.track``, ``semantic_info``,
``logger.memory``, ``run.tail``; ``map_insert`` (``.grow``, ``.upload``,
``.capture``, ``.dispatch``); ``mask_source`` (``.upload``, ``.encode``,
``.decode``, ``.select``, ``.box_nms``, ``.mask_nms``, ``.upsample``,
``.seg_map``, ``.stack``, ``.small_regions``); ``association``
(``.grow``, ``.upload``, ``.match``, ``.votes``, ``.tail``, ``.fused``,
``.sharded``); ``embedder`` (``.gate``, ``.tower``, ``.pool``, ``.crops``,
``.merger``, ``.update``); waits ``wait.insert_count``,
``wait.insert_stage``, ``wait.has_mask``, ``wait.next_id``,
``wait.valid_any``, ``wait.keep_any``, ``wait.dropped``,
``wait.small_regions``, ``wait.log``, ``wait.debug``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler

_time_ns = time.time_ns
_get_ident = threading.get_ident
# ``_flags._is_profiler_enabled``: whether a profiler runs, the flag PyTorch
# keeps for fast Python checks (torch 2.11 and 2.13 both have it)
_flags = _autograd_profiler


class Span(NamedTuple):
    """A recorded span; the first three fields are ``check.Probe``'s."""
    name: str
    t0_ns: int
    t1_ns: int
    parent: int          # index of the enclosing span, -1 at the top
    frame_id: Optional[int]
    n_kf: int
    thread: int          # the recording thread's ident


class Records(NamedTuple):
    """One window's spans and counters."""
    spans: List[Span]
    counters: Dict[str, int]              # name -> total
    gauges: Dict[str, float]              # name -> last value
    samples: List[tuple]                  # (t_ns, name, value)
    threads: Dict[int, str]               # ident -> thread name


class _Window:
    def __init__(self):
        self.spans: List[list] = []       # open spans have t1 None
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.samples: List[tuple] = []
        self.threads: Dict[int, str] = {}


_window: Optional[_Window] = None        # the open window
_last_window: Optional[_Window] = None   # the last, open or closed
_last: Dict[str, tuple] = {}            # name -> (t0_ns, t1_ns, n_kf)
_local = threading.local()              # .stack: the thread's open spans


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _recording() -> Optional[_Window]:
    """The window to record into while the profiler runs; None, and the
    last window closed, when it does not."""
    global _window, _last_window
    if _flags._is_profiler_enabled:
        if _window is None:
            _window = _last_window = _Window()
        return _window
    _window = None
    return None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("window", "rec", "name", "n_kf", "t0")

    def __init__(self, window, name, frame_id, n_kf):
        self.window, self.name, self.n_kf = window, name, n_kf
        self.rec = None
        stack = _stack()
        if window is not None:
            parent = stack[-1] if stack else None
            if parent is not None and parent.window is not window:
                parent = None
            if frame_id is None and parent is not None:
                frame_id = parent.rec[4]
            ident = _get_ident()
            if ident not in window.threads:
                window.threads[ident] = threading.current_thread().name
            self.rec = [name, 0, None,
                        -1 if parent is None else parent.index, frame_id,
                        n_kf, ident]

    @property
    def index(self) -> int:
        return self.rec[7]

    def __enter__(self):
        _stack().append(self)
        self.t0 = _time_ns()
        if self.rec is not None:
            spans = self.window.spans
            self.rec[1] = self.t0
            spans.append(self.rec)
            # the index, for the children: appends from other threads may
            # interleave, so it is looked up, once, from the end
            i = len(spans) - 1
            while spans[i] is not self.rec:
                i -= 1
            self.rec.append(i)
        return self

    def __exit__(self, *exc):
        t1 = _time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.rec is not None:
            self.rec[2] = t1
        _last[self.name] = (self.t0, t1, self.n_kf)
        return False


def span(name: str, frame_id: Optional[int] = None, n_kf: int = 1,
         keep: bool = False):
    """A context manager that records the host interval of ``name`` while
    a profiler runs (``keep``: also outside, for :func:`last_seconds`)."""
    if _flags._is_profiler_enabled or keep or _window is not None:
        w = _recording()
        if w is not None or keep:
            return _Span(w, name, frame_id, n_kf)
    return _OFF


def wait(name: str, frame_id: Optional[int] = None):
    """:func:`span` ``wait.<name>``, around a host read of a device value."""
    if _flags._is_profiler_enabled or _window is not None:
        w = _recording()
        if w is not None:
            return _Span(w, "wait." + name, frame_id, 1)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler runs."""
    if _flags._is_profiler_enabled:
        w = _recording()
        w.counters[name] += n
        w.samples.append((_time_ns(), name, w.counters[name]))


def gauge(name: str, value) -> None:
    """Set gauge ``name`` while a profiler runs."""
    if _flags._is_profiler_enabled:
        w = _recording()
        w.gauges[name] = value
        w.samples.append((_time_ns(), name, value))


def count_launch() -> None:
    """A kernel launch, counted under the innermost open span's name
    (``port_launches.<span>``) while a profiler runs."""
    if _flags._is_profiler_enabled:
        stack = _stack()
        _recording().counters["port_launches." + (
            stack[-1].name if stack else "(none)")] += 1


def last_seconds(name: str, per_kf: bool = False) -> Optional[float]:
    """The host seconds of the newest closed span ``name`` timed while
    recording or with ``keep`` (over its ``n_kf`` with ``per_kf``); None if
    there is none."""
    rec = _last.get(name)
    if rec is None:
        return None
    return (rec[1] - rec[0]) / 1e9 / (rec[2] if per_kf else 1)


def records() -> Records:
    """The last window's closed spans (indices and parents as recorded;
    an open span's end reads as now) and counters. Read outside a window,
    it closes the window, so that the next profiler's first span opens a
    new one."""
    w = _recording() or _last_window
    if w is None:
        return Records([], {}, {}, [], {})
    now = _time_ns()
    spans = [Span(r[0], r[1], now if r[2] is None else r[2], r[3], r[4],
                  r[5], r[6]) for r in list(w.spans)]
    return Records(spans, dict(w.counters), dict(w.gauges), list(w.samples),
                   dict(w.threads))


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------

PID = "ovo_tpu_torch"


def chrome_events(rec: Records, base_ns: int) -> List[dict]:
    """The records as Chrome trace events on a trace whose
    ``baseTimeNanoseconds`` is ``base_ns``: one process track, a thread row
    per recording thread, spans as complete events, counters as ``C``."""
    rows = {ident: i for i, ident in enumerate(sorted(rec.threads))}
    out = [{"ph": "M", "name": "process_name", "pid": PID,
            "args": {"name": PID}}]
    out += [{"ph": "M", "name": "thread_name", "pid": PID, "tid": rows[i],
             "args": {"name": rec.threads[i]}} for i in rows]
    for s in rec.spans:
        args = {"n_kf": s.n_kf}
        if s.frame_id is not None:
            args["frame_id"] = s.frame_id
        out.append({"ph": "X", "cat": PID, "name": s.name, "pid": PID,
                    "tid": rows.get(s.thread, 0),
                    "ts": (s.t0_ns - base_ns) / 1e3,
                    "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
    for t, name, value in rec.samples:
        out.append({"ph": "C", "name": name, "pid": PID,
                    "ts": (t - base_ns) / 1e3, "args": {name: value}})
    return out


def export_chrome(path) -> None:
    """Add the window's records to the Chrome trace at ``path`` (written by
    ``torch.profiler``'s ``export_chrome_trace``), in place."""
    path = Path(path)
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    data.setdefault("traceEvents", []).extend(chrome_events(records(),
                                                            base))
    path.write_text(json.dumps(data))
