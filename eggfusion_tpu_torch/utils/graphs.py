"""The port's compile layer: the frame's programs as captured CUDA graphs
(the counterpart of the JAX package's `jax.jit` programs and their lowering
cache, `eggfusion_tpu/system.py::warmup`, `core/mapper.py:1058-1130`).

A `Program` wraps one function `fn(state, inputs, **static)` of tensors.
It keeps one entry per key, as a jitted JAX function keeps one executable
per signature: the key holds the static arguments, the capacity rung, the
structure, shape, stride and dtype of every tensor, and the address of every
state tensor. An entry owns
  * static input buffers: each call copies its inputs into them (`copy_`),
    except an input that already sits at the captured address;
  * the state: tensors the function updates in place (the surfel map, the
    Adam moments). They are the caller's own buffers and never copied; a
    state at another address is another key;
  * the outputs: they belong to the entry, and the next call of the same
    key overwrites them. A consumer that keeps one across that call clones
    it.

How a `Programs` runs its programs (`mode`):
  "graph" — on CUDA: a `torch.cuda.CUDAGraph` per entry, captured at first
            use (or ahead of it, `prepare`) after `WARM_ITERS` eager runs on
            a side stream over clones of the state (cuBLAS, cuSOLVER, the
            kernels' libraries and the allocator set up; the state itself
            untouched), each in its own memory pool: graphs replay in a
            varying order (opt steps per frame, map-update variants), so no
            pool is shared. A capture that fails raises.
  "plumb" — on the CPU: no graph; the function runs eagerly through the same
            static inputs and outputs. `poison` (tests only) fills the
            previous outputs of a key with NaN (integers with -2**30,
            booleans inverted) before its next call, as a replay overwrites
            them, so a consumer that keeps an output shows up.
  "eager" — the function is called directly (`EGGFusion(graphs=False)`, the
            counterpart of `jax.disable_jit`).

Devices: a program runs on the `Programs`' device unless a call names
another (`device=`, the mesh's per-GPU programs). An entry's static inputs,
its capture and its replay are on its own device: each GPU has its own side
stream, the entry its own pool, and a replay runs on that GPU's current
stream, so PyTorch's two-way ordering of a peer copy (`copy_` between GPUs)
orders it against the replays on both sides. A call's inputs may lie on
another device: loading them into the static buffers is the peer copy. The
device is part of the key, and so is a mesh shard's index (a static), so two
shards on one device keep their own outputs.

Making an entry (its static inputs, and in "graph" mode the warm runs and
the capture) runs under the span "capture" (`utils/trace.py`), whose host
time goes into the frame's `capture_ms`.

Kernel launches: `raster_tile.LAUNCHES` (and `LAUNCHES_BY_DEVICE`) count
calls of the kernel wrappers, which a replay does not make. Each entry
records the launches its capture made, by device (and takes them back out:
a capture launches nothing) and adds them at every replay, so the counts
stay those of real launches. The launches of the eager runs before a
capture are real and counted; `Programs.warm_launches` keeps them apart
too, so a graph run's counts less those equal the eager run's.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from eggfusion_tpu_torch.ops.raster_tile import LAUNCHES, LAUNCHES_BY_DEVICE
from eggfusion_tpu_torch.utils import trace

# eager runs of a program before its capture (on clones of its state)
WARM_ITERS = 2


# ---------------------------------------------------------------- pytrees --


def flatten(tree):
    """(spec, tensors) of a nest of dicts, tuples, lists, NamedTuples and
    dataclasses; anything else that is not a tensor is part of the spec (a
    constant baked into the program)."""
    leaves = []
    return _walk(tree, leaves), leaves


# `_walk` and `_build` are module functions, not closures: a recursive
# closure is a reference cycle, and its cell would hold every tensor it saw
# until the garbage collector ran, so the device's peak would follow when
# the collector runs
def _walk(x, leaves: list):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return "T"
    if isinstance(x, dict):
        return ("D", tuple(x), tuple(_walk(v, leaves) for v in x.values()))
    if isinstance(x, (tuple, list)):
        return ("S", type(x), tuple(_walk(v, leaves) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return ("C", type(x), names, tuple(_walk(getattr(x, n), leaves) for n in names))
    return ("V", x)


def unflatten(spec, leaves):
    return _build(spec, iter(leaves))


def _build(sp, it):
    if sp == "T":
        return next(it)
    kind = sp[0]
    if kind == "D":
        return dict(zip(sp[1], (_build(c, it) for c in sp[2])))
    if kind == "S":
        items = [_build(c, it) for c in sp[2]]
        typ = sp[1]
        if typ is list:
            return items
        return typ(*items) if hasattr(typ, "_fields") else typ(items)
    if kind == "C":
        return sp[1](**dict(zip(sp[2], (_build(c, it) for c in sp[3]))))
    return sp[1]


def _sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), tuple(t.stride()), t.dtype, t.device


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bits (NaN equal to the same NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8), b.reshape(-1).contiguous().view(torch.uint8))


def _launch_counts() -> tuple[dict, dict]:
    return dict(LAUNCHES), dict(LAUNCHES_BY_DEVICE)


def _restore_launch_counts(saved: tuple[dict, dict]) -> None:
    LAUNCHES.update(saved[0])
    LAUNCHES_BY_DEVICE.clear()
    LAUNCHES_BY_DEVICE.update(saved[1])


def _poison(t: torch.Tensor) -> None:
    if t.dtype == torch.bool:
        t.logical_not_()
    elif t.is_floating_point():
        t.fill_(float("nan"))
    else:
        t.fill_(-(2 ** 30))


# --------------------------------------------------------------- programs --


class _Entry:
    """One key of a program: its static inputs, state, outputs and graph."""

    def __init__(self, static: dict, rung, device, state_spec, state: list, in_spec, inputs: list):
        self.static, self.rung, self.device = static, rung, device
        self.state_spec, self.state = state_spec, state
        self.in_spec, self.inputs = in_spec, inputs
        self.graph = None
        self.outputs = None
        self.launches: dict = {}  # "kernel:device" -> launches of one replay
        self.pool_bytes = 0
        self.capture_s = 0.0

    def state_tree(self):
        return unflatten(self.state_spec, self.state)

    def input_tree(self):
        return unflatten(self.in_spec, self.inputs)

    def load(self, leaves: list) -> None:
        for src, dst in zip(leaves, self.inputs):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)


class Program:
    """One function run through the program cache of a `Programs`; see the
    module docstring. `captures` counts entries made, `replays` calls of an
    entry, `capture_s` the seconds spent capturing."""

    def __init__(self, name: str, fn, programs: "Programs"):
        self.name, self.fn, self.programs = name, fn, programs
        self.entries: dict = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.last = None  # the entry of the last call

    def __call__(self, static: dict, state, inputs, rung=None, device=None):
        if self.programs.mode == "eager":
            return self.fn(state, inputs, **static)
        entry, leaves = self._entry(static, state, inputs, rung, device)
        if self.programs.mode == "plumb":
            if self.programs.poison and entry.outputs is not None:
                keep = {x.untyped_storage().data_ptr() for x in leaves + entry.state}
                for t in flatten(entry.outputs)[1]:
                    if t.untyped_storage().data_ptr() not in keep:
                        _poison(t)
            entry.load(leaves)
            entry.outputs = self.fn(entry.state_tree(), entry.input_tree(), **static)
        else:
            entry.load(leaves)
            with torch.cuda.device(entry.device):
                entry.graph.replay()
            for k, n in entry.launches.items():
                LAUNCHES[k.split(":", 1)[0]] += n
                LAUNCHES_BY_DEVICE[k] = LAUNCHES_BY_DEVICE.get(k, 0) + n
        self.replays += 1
        self.last = entry
        return entry.outputs

    def prepare(self, static: dict, state, inputs, rung=None, device=None):
        """Capture the key of these arguments now, if it is not yet
        captured, without running it (the state stays as it is); returns
        its entry (None when eager)."""
        if self.programs.mode != "eager":
            return self._entry(static, state, inputs, rung, device)[0]
        return None

    def _entry(self, static: dict, state, inputs, rung, device):
        dev = self.programs.device if device is None else torch.device(device)
        state_spec, state_leaves = flatten(state)
        in_spec, leaves = flatten(inputs)
        key = (tuple(sorted(static.items())), rung, dev, state_spec, in_spec,
               tuple(_sig(t) + (t.data_ptr(),) for t in state_leaves), tuple(_sig(t) for t in leaves))
        entry = self.entries.get(key)
        if entry is None:
            with trace.waiting("capture"):
                statics = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=dev).copy_(t)
                           for t in leaves]
                entry = _Entry(static, rung, dev, state_spec, state_leaves, in_spec, statics)
                if self.programs.mode == "graph":
                    self._capture(entry)
            self.entries[key] = entry
            self.captures += 1
        return entry, leaves

    def _capture(self, entry: _Entry) -> None:
        t0 = time.perf_counter()
        dev = entry.device
        main = torch.cuda.current_stream(dev)
        side = self.programs.side_stream(dev)
        side.wait_stream(main)
        warm = dict(LAUNCHES_BY_DEVICE)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            for _ in range(WARM_ITERS):
                scratch = [t.clone() for t in entry.state]
                self.fn(unflatten(entry.state_spec, scratch), entry.input_tree(), **entry.static)
                del scratch
        main.wait_stream(side)
        for k, n in LAUNCHES_BY_DEVICE.items():
            if n != warm.get(k, 0):
                self.programs.warm_launches[k] = self.programs.warm_launches.get(k, 0) + n - warm.get(k, 0)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(dev), torch.cuda.graph(graph, pool=pool, stream=side,
                                                      capture_error_mode="thread_local"):
            outputs = self.fn(entry.state_tree(), entry.input_tree(), **entry.static)
        main.wait_stream(side)
        entry.launches = {k: n - before[1].get(k, 0) for k, n in LAUNCHES_BY_DEVICE.items()
                          if n != before[1].get(k, 0)}
        _restore_launch_counts(before)
        entry.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
        entry.graph, entry.outputs = graph, outputs
        entry.capture_s = time.perf_counter() - t0
        self.capture_s += entry.capture_s

    def drop(self, rung=None) -> None:
        """Forget the entries of capacity rung `rung` (all with None): their
        state buffers were left or replaced."""
        self.entries = {k: e for k, e in self.entries.items() if rung is not None and e.rung != rung}
        if self.last is not None and (rung is None or self.last.rung == rung):
            self.last = None

    def check_replay(self, entry: _Entry | None = None) -> dict:
        """Replay a captured entry (the last one called by default) and call
        the function eagerly on the same static inputs from the same state;
        returns whether every output and every state tensor came out bit for
        bit the same. The state ends as the eager call leaves it. Launches
        made here are not counted."""
        e = entry or self.last
        if e is None or e.graph is None:
            raise RuntimeError(f"program {self.name}: no captured entry to check")
        counts = _launch_counts()
        start = [t.clone() for t in e.state]
        with torch.cuda.device(e.device):
            e.graph.replay()
        out_g = [t.clone() for t in flatten(e.outputs)[1]]
        state_g = [t.clone() for t in e.state]
        for t, t0 in zip(e.state, start):
            t.copy_(t0)
        out_e = flatten(self.fn(e.state_tree(), e.input_tree(), **e.static))[1]
        _restore_launch_counts(counts)
        out_eq = len(out_e) == len(out_g) and all(same_bits(a, b) for a, b in zip(out_e, out_g))
        state_eq = all(same_bits(a, b) for a, b in zip(e.state, state_g))
        return {"program": self.name, "outputs": len(out_g), "state": len(state_g),
                "outputs_equal": out_eq, "state_equal": state_eq}


class Programs:
    """The programs of one system. `graphs` None: CUDA graphs on a CUDA
    device, eager on the CPU; True: graphs, or the CPU plumbing; False:
    eager."""

    def __init__(self, device, graphs: bool | None = None):
        self.device = torch.device(device)
        on = self.device.type == "cuda" if graphs is None else bool(graphs)
        self.mode = ("graph" if self.device.type == "cuda" else "plumb") if on else "eager"
        self.poison = False  # plumbing only; for tests
        self.programs: dict[str, Program] = {}
        self._side: dict = {}  # device -> side stream of its captures
        self.warm_launches: dict = {}  # "kernel:device" -> launches of the eager runs before captures

    @property
    def enabled(self) -> bool:
        return self.mode != "eager"

    def program(self, name: str, fn) -> Program:
        """The program `name`, made for `fn` at its first request."""
        p = self.programs.get(name)
        if p is None:
            p = self.programs[name] = Program(name, fn, self)
        elif p.fn != fn:
            raise ValueError(f"program {name!r} exists for another function")
        return p

    def side_stream(self, device=None):
        dev = self.device if device is None else torch.device(device)
        if dev not in self._side:
            self._side[dev] = torch.cuda.Stream(dev)
        return self._side[dev]

    def drop(self, rung=None) -> None:
        """Forget every program's entries of rung `rung` (all with None)."""
        for p in self.programs.values():
            p.drop(rung)

    def captures(self) -> int:
        return sum(p.captures for p in self.programs.values())

    def stats(self) -> dict:
        """Per program: captures, replays, capture seconds and the pool bytes
        of its live entries by rung."""
        out = {}
        for name, p in self.programs.items():
            pools: dict = {}
            for e in p.entries.values():
                pools[str(e.rung)] = pools.get(str(e.rung), 0) + e.pool_bytes
            out[name] = {"captures": p.captures, "replays": p.replays, "capture_s": p.capture_s,
                         "entries": len(p.entries), "pool_bytes": pools}
        return out
