"""The vanilla map insert replayed as one CUDA graph.

``map_insert_frame`` is ~200 small launches whose host dispatch costs far
more than their device time. On a CUDA map its launches depend only on the
frame's shapes and dtypes, the map's capacity and buffers, the insert's
parameters and the intrinsics: :func:`insert_key`. At a fixed key the
insert is captured once and then replayed, fed through one persistent
pinned slot: the frame is copied into the slot on the host, from there by
one copy into the graph's fixed device inputs, the map's ``count`` and
``next_point_id`` into its fixed scalars, and one graph launch does the
rest. The first insert at a new key runs eagerly (the warm-up; a capture
executes nothing), the next is captured and replayed, and a new key
releases the graph (:func:`decide`). Each capture shares the released
graph's memory pool, so the temporaries of one insert stay reserved once,
not once a key.

A replay runs the captured kernels on the same inputs, so its results are
the eager insert's bit for bit. The buffers are updated in place, as the
eager insert does; the returned state's ``count`` and ``next_point_id``
are copies of the graph's outputs, which the next replay overwrites.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from .map_state import MapState

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"
_ALIGN = 256  # bytes between the slot's fields: whole vector loads


def insert_key(state: MapState, image, depth, K: torch.Tensor, *,
               k_pooling: int, downscale: int,
               match_th: float) -> Optional[tuple]:
    """What a captured insert's launches depend on, for a frame given as
    host arrays; None where the insert runs eagerly: a frame whose
    subsampled grid covers the whole map (the tiny-map branch of
    ``_scatter_append``). The map's ``count`` and ``next_point_id`` are
    not part of it: they are copied in."""
    h, w = depth.shape
    ds = max(downscale, 1)
    if -(-h // ds) * -(-w // ds) >= state.capacity:
        return None
    return (image.shape, image.dtype.str, depth.shape, depth.dtype.str,
            state.capacity, downscale, k_pooling, match_th, K.data_ptr(),
            state.points.data_ptr(), state.point_ids.data_ptr(),
            state.obj_ids.data_ptr(), state.colors.data_ptr())


def decide(key, warm_key, graph_key) -> Tuple[str, bool]:
    """(action, release): replay the graph held at ``key``; capture at the
    key the last insert warmed up eagerly; else run eagerly, which warms
    ``key`` up. ``release``: drop the graph held at another key."""
    if key is not None and key == graph_key:
        return REPLAY, False
    release = graph_key is not None
    if key is not None and key == warm_key:
        return CAPTURE, release
    return EAGER, release


class InsertGraph:
    """One captured insert of a CUDA map, its pinned slot and its fixed
    device inputs and outputs. :meth:`plan` first; for a capture or a
    replay then :meth:`stage`, :meth:`capture` (a capture only) and
    :meth:`replay`."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.warm_key = None
        self.key = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[MapState] = None
        self._layout = None
        self._stream = None           # the side stream captures run on
        self._count = torch.zeros((), dtype=torch.int32, device=device)
        self._next_id = torch.zeros((), dtype=torch.int32, device=device)

    def plan(self, key) -> str:
        """The action for an insert at ``key`` (:func:`decide`)."""
        action, release = decide(key, self.warm_key, self.key)
        if release:
            # no longer replayed; kept until the next capture, which takes
            # over its memory pool
            self.key = self._out = None
        if action == EAGER:
            self.warm_key = key
        return action

    def _allocate(self, image: np.ndarray, depth: np.ndarray) -> None:
        """The device inputs (image, depth, c2w and w2c at aligned offsets
        of one buffer) and a pinned slot of that layout."""
        fields = [(image.shape, image.dtype), (depth.shape, depth.dtype),
                  ((4, 4), np.dtype(np.float32)),
                  ((4, 4), np.dtype(np.float32))]
        self._fields, n = [], 0
        for shape, dt in fields:
            nb = int(np.prod(shape)) * dt.itemsize
            tdt = torch.from_numpy(np.empty(0, dt)).dtype
            self._fields.append((n, nb, tdt, shape))
            n += -(-nb // _ALIGN) * _ALIGN
        self._dev = torch.empty(n, dtype=torch.uint8, device=self.device)
        self._inputs = self._views(self._dev)
        self._slot = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        self._slot_views = self._views(self._slot)
        self._copied = torch.cuda.Event()     # the slot's last copy
        self._layout = (image.shape, image.dtype, depth.shape, depth.dtype)

    def _views(self, buf: torch.Tensor) -> list:
        return [buf[o:o + nb].view(dt).view(shape)
                for o, nb, dt, shape in self._fields]

    def stage(self, state: MapState, image: np.ndarray, depth: np.ndarray,
              c2w: np.ndarray, w2c: np.ndarray) -> None:
        """The frame into the pinned slot once its last copy is done
        (``wait.insert_stage`` while it is not), the slot into the device
        inputs, and the map's scalars into the graph's: all on the current
        stream."""
        if self._layout != (image.shape, image.dtype, depth.shape,
                            depth.dtype):
            self._allocate(image, depth)
        if not self._copied.query():
            with trace.wait("insert_stage"):
                self._copied.synchronize()
        for dst, src in zip(self._slot_views, (image, depth, c2w, w2c)):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        self._dev.copy_(self._slot, non_blocking=True)
        self._copied.record()
        self._count.copy_(state.count)
        self._next_id.copy_(state.next_point_id)

    def capture(self, key, insert_fn, state: MapState, K: torch.Tensor,
                **kw) -> None:
        """Capture ``insert_fn`` (``map_insert_frame``'s signature) on the
        staged inputs and ``state``'s buffers as the graph held at
        ``key``. Nothing runs: :meth:`replay` does the insert. Captured on
        a side stream without ``torch.cuda.graph``, whose entry
        synchronizes the card and empties the allocator's cache: the
        online loop must not block on the card."""
        image, depth, c2w, w2c = self._inputs
        fixed = state._replace(count=self._count,
                               next_point_id=self._next_id)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        pool = None if self.graph is None else self.graph.pool()
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = insert_fn(fixed, image, depth.to(torch.float32), c2w,
                                K, w2c=w2c, **kw)
            finally:
                graph.capture_end()
        self.graph, self.key, self._out = graph, key, out

    def replay(self) -> MapState:
        """Launch the graph; the state it returns, with copies of its
        scalars."""
        self.graph.replay()
        out = self._out
        return out._replace(count=out.count.clone(),
                            next_point_id=out.next_point_id.clone())
