"""Spans and counters of the port, on the profiler's clock.

**Spans** mark the port's layers for ``torch.profiler``: :func:`span`
opens a ``record_function`` named ``wcn.<layer>...`` while recording and
is a shared no-op context otherwise, so a call with no profiler pays one
check (``torch.autograd._profiler_enabled()``, 0.14 us on an H100 host).
Spans nest: the parent of a span is the span around its call. The names:

- ``wcn.train_step`` and its phases ``wcn.train_step.forward``, ``.loss``,
  ``.backward``, ``.optimizer`` (``parallel/train.py``);
- ``wcn.model.minkunet``, ``wcn.model.volt``: a model's forward;
- ``wcn.map.<function>``: each builder of the coordinate engine;
- ``wcn.conv.<fwd|bwd>[kind B N_in->N_out C_in->C_out K stride dtype]``:
  a table conv's kernels, kind ``sub`` (a self-map), ``onto`` (stride 1
  onto other coordinates), ``down`` (strided) or ``up`` (transposed),
  ``dw-`` before it for a depthwise conv;
- ``wcn.attn.<fwd|bwd>[B S H D dtype]``: a segment attention's kernels;
- ``wcn.sync.<function>``: a host call that blocks on the card (a copy of
  host data to the card, a read of a card value on the host).

**Counters**, one registry. Host counters (:func:`add`) always count; the
kernel wrappers count their launches as ``launches.<wrapper>``. Device
counters are int64 slots of one buffer a device, to which the kernels add
with atomics (:func:`counter_ptr`) or the wrappers with a reduction on the
device (:func:`device_add`); they count only while recording: otherwise
the wrappers pass a null pointer and the kernels skip their atomics, so a
count covers exactly the profiled slice. :func:`counters` reads both.

Recording means a ``torch.profiler`` session records, or a
:func:`recording` context is open (tests and tools).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

_profiler_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_forced = 0  # open recording() contexts

# Device slots, in this order; K1's, K4's and the K9 family's visit pairs
# are adjacent, as their kernels take one pointer and add to it and to the
# next slot.
DEVICE_KEYS = (
    "k1.tiles",  # K1 tiles with a valid query
    "k1.wide_tiles",  # of those, walked in device memory (the window did not fit)
    "k2.fwd_tile_work",  # K2 forward: 64 rows for each (tile, offset) a tile computed
    "k2.fwd_pairs",  # K2 forward: table entries >= 0 (the useful rows of that work)
    "k2.dgrad_tile_work",  # K2 as dgrad, as k2.fwd_tile_work
    "k4.tile_work",  # K4's dx tiles, as k2.fwd_tile_work
    "k4.dw_floats",  # floats K4's dw blocks added into dw
    "k3.dw_floats",  # floats K3's blocks added into dw
    "k8.dw_floats",  # floats K8's dw blocks added into dw
    "k7.dw_floats",  # floats K7's blocks added into dw
    "k9.fwd_staged_rows",  # fp32 K9: kv rows its blocks copied in (pre-split, by bulk copy)
    "k9.bwd_staged_rows",  # fp32 K9-dkv and K9-dq: visited rows their blocks copied in (as K9)
    "k9.range_blocks",  # K9 family: blocks that took their visited tiles from the visit pre-pass
    "k9.scan_blocks",  # K9 family: blocks that scanned their scene's ids instead (not sorted)
)
_SLOT = {k: i for i, k in enumerate(DEVICE_KEYS)}
_device_counts: Dict[torch.device, torch.Tensor] = {}
_host_counts: Dict[str, int] = {}
# Open spans while recording, outermost first: one stack for the process,
# as the autograd engine runs a backward's spans on its own thread while
# the caller waits.
_open: List["_Span"] = []


def is_recording() -> bool:
    """A profiler records, or a :func:`recording` context is open."""
    return _forced > 0 or _profiler_enabled()


@contextlib.contextmanager
def recording():
    """Record without a profiler: spans open (and :func:`open_spans` sees
    them) and device counters count, as under ``torch.profiler``."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


class _Span:
    __slots__ = ("name", "_fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.remove(self)
        self._fn.__exit__(*exc)
        return False


def span(name: str, detail: Optional[Callable[[], str]] = None):
    """A context marking ``name`` (with ``[detail()]`` appended, formatted
    only while recording) on the profiler's clock; a shared no-op context
    when nothing records."""
    if not is_recording():
        return _NULL
    return _Span(name if detail is None else f"{name}[{detail()}]")


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not is_recording():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def open_spans() -> Tuple[str, ...]:
    """Names of the spans open now, outermost first (empty unless recording)."""
    return tuple(s.name for s in _open)


def add(key: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``key``."""
    _host_counts[key] = _host_counts.get(key, 0) + n


def _index(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _buffer(device: torch.device) -> torch.Tensor:
    device = _index(device)
    if device not in _device_counts:
        _device_counts[device] = torch.zeros(len(DEVICE_KEYS), dtype=torch.int64, device=device)
    return _device_counts[device]


def counter_ptr(device, key: str) -> Optional[int]:
    """Address of ``key``'s int64 slot on ``device`` for a kernel to add
    to while recording; None (a null pointer: the kernel counts nothing)
    otherwise."""
    if not is_recording():
        return None
    return _buffer(device).data_ptr() + 8 * _SLOT[key]


def device_add(key: str, value: Callable[[], torch.Tensor]) -> None:
    """While recording, add the 0-d integer tensor that ``value()`` gives
    (called only then) to ``key``'s slot on its device, on the device (no
    synchronisation)."""
    if is_recording():
        v = value()
        _buffer(v.device)[_SLOT[key]].add_(v)


def counters(device=None) -> Dict[str, int]:
    """Every host counter and every device slot (zero where nothing was
    counted) of ``device``, or summed over the devices with None.
    Synchronises with the devices read."""
    devices = list(_device_counts) if device is None else [_index(device)]
    out = dict.fromkeys(DEVICE_KEYS, 0)
    for d in devices:
        if d in _device_counts:
            for k, v in zip(DEVICE_KEYS, _device_counts[d].tolist()):
                out[k] += v
    out.update(_host_counts)
    return out


def reset_counters() -> None:
    """Zero every host counter and device slot."""
    _host_counts.clear()
    for buf in _device_counts.values():
        buf.zero_()
