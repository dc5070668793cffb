"""One run of one cell: build the program, bring it to its steady state,
measure for the window, and check what it served.

The program is the port's serving engine.  The harness builds its
scheduler over ``engine.make_pool()``, ``engine.decode_fn`` and
``engine.chunk_fn``, as ``ServeEngine.run`` does, with the continuous
policy and greedy requests, and drives it in ``Scheduler.run``'s order
(``validate``, ``reset``, requests onto ``queue``,
``admit_from_queue``, ``step``, ``has_work``), except that it releases
each request at its due time on the wall clock and stamps that time
itself.  Of the program's stamps it reads ``t_admit``, ``t_first`` and
``t_done``; each later token is stamped when the step that made it
returns.

The weights are the benchmark's: drawn from the seed in the layout of
``reference.layout`` (checked against the program's own table) and set
as the engine's parameters.  After the window the program is freed and
``judge`` draws them again for the plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from portbench import counts, generator, reference

TRACE_S = 8.0             # the window's last seconds under the profiler
GRACE_S = 60.0            # wait past the close for due first tokens


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload with the files its names lead to."""
    root: Path
    bench: dict
    workload: dict
    config: dict
    mix: dict
    limits: dict

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def engine(self) -> dict:
        """The deployment's engine settings: the configuration's
        ``engine``, with its ``engine_by_traffic`` entry for this mix
        where it has one."""
        by_mix = self.config.get("engine_by_traffic", {})
        return {**self.config["engine"],
                **by_mix.get(self.workload["traffic"], {})}

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self._has(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or \
            self.workload["name"] in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its configuration
    file, its mix (``portbench/traffic/<traffic>.json``) and its limits
    (``portbench/limits/<cell>.json``)."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    return Cell(root, bench, w, config, mix, limits)


def reader(root: Path, metric: str):
    """The ``read(record)`` of a per-layer metric: the module
    ``portbench/metrics/<base>.py`` of a name ``<base>.<cells>`` (one
    reader serves the metric in every cell that reports it)."""
    path = Path(root) / "portbench" / "metrics" / \
        f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the program


def build_engine(cell: Cell, seed: int, device: str):
    """The engine of the cell's configuration and deployment, serving the
    benchmark's weights of ``seed``."""
    from repro_torch.serving.engine import ServeEngine
    eng_cfg = cell.engine
    engine = ServeEngine(arch=cell.config["arch"],
                         num_slots=eng_cfg["num_slots"],
                         max_len=eng_cfg["max_len"],
                         prefill_chunk=eng_cfg.get("prefill_chunk"),
                         kv_layout="paged", log=lambda *a: None,
                         device=device)
    check_config(cell, engine.cfg)
    table = program_layout(engine.model.param_table())
    ours = {p: s for p, s, _, _ in reference.layout(cell.model)}
    if table != ours:
        raise SystemExit(f"the program's weights {table} are not the "
                         f"layout the benchmark draws {ours}")
    engine.params = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    engine.params = reference.make_weights(cell.model, seed, device)
    return engine


def program_layout(table, path=()) -> dict:
    out = {}
    for k, v in table.items():
        if isinstance(v, dict):
            out.update(program_layout(v, path + (k,)))
        else:
            out[path + (k,)] = tuple(v.shape)
    return out


_CONFIG_FIELDS = {"layers": "num_layers", "d_model": "d_model",
                  "heads": "num_heads", "kv_heads": "num_kv_heads",
                  "head_dim": "head_dim", "d_ff": "d_ff",
                  "vocab": "vocab_size", "norm": "norm",
                  "rope_fraction": "rope_fraction",
                  "rope_theta": "rope_theta", "experts": "num_experts",
                  "top_k": "experts_per_token",
                  "capacity_factor": "capacity_factor"}


def check_config(cell: Cell, cfg) -> None:
    """The program's configuration of the arch is the file's model."""
    m = cell.model
    bad = {k: (m[k], getattr(cfg, f)) for k, f in _CONFIG_FIELDS.items()
           if k in m and m[k] != getattr(cfg, f)}
    if cfg.qkv_bias or cfg.tie_embeddings or cfg.activation != "silu" or \
            cfg.pos != "rope":
        bad["block"] = (cfg.qkv_bias, cfg.tie_embeddings, cfg.activation,
                        cfg.pos)
    if bad:
        raise SystemExit(f"{cell.config['arch']}: the program's "
                         f"configuration differs from the file: {bad}")


# ---------------------------------------------------------------------------
# the run's record


@dataclasses.dataclass
class Req:
    rid: int
    prompt: np.ndarray
    due: float                         # host clock
    release: float = math.nan
    admit: float = math.nan
    first: float = math.nan
    done: float = math.nan
    times: list = dataclasses.field(default_factory=list)  # per token
    tokens: list | None = None
    chunks: list = dataclasses.field(default_factory=list)
    preemptions: int = 0


@dataclasses.dataclass
class Record:
    """What a run saw: requests, the steps' calls, the window, and in a
    traced run the CUDA-event times of the calls and the profiler's
    reading.  The per-layer readers read it."""
    model: dict
    num_slots: int
    loop: str
    t_open: float = 0.0
    t_close: float = 0.0
    t_quiet: float = 0.0       # the profiler's start, or the close
    profile_start_s: float = 0.0  # what starting the profiler took
    seconds: float = 0.0
    reqs: dict = dataclasses.field(default_factory=dict)
    ticks: list = dataclasses.field(default_factory=list)   # (t, active, resident)
    chunks: list = dataclasses.field(default_factory=list)  # (t, slot, off, n, padded)
    tick_ms: list = dataclasses.field(default_factory=list)
    chunk_ms: list = dataclasses.field(default_factory=list)
    profile: dict | None = None
    plan: dict = dataclasses.field(default_factory=dict)
    host: list = dataclasses.field(default_factory=list)    # (kind, t, s)
    steps: list = dataclasses.field(default_factory=list)   # (t, s)

    def in_window(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close

    def due_in_window(self) -> list[Req]:
        return [r for r in self.reqs.values()
                if self.t_open <= r.due < self.t_open + self.seconds]

    def in_quiet(self, t: float) -> bool:
        """In the window, before a profiler started."""
        return self.t_open <= t < self.t_quiet

    def due_in_quiet(self) -> list[Req]:
        return [r for r in self.reqs.values() if self.in_quiet(r.due)]

    @property
    def quiet_s(self) -> float:
        return self.t_quiet - self.t_open

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


class Calls:
    """The engine's steps as the scheduler calls them, recorded: each
    decode tick's live slots and resident keys, each chunk's slot,
    offset, tokens and padded size; with ``events`` also CUDA events
    around each call, and with a profiler running labels for its
    trace."""

    def __init__(self, engine, rec: Record, events: bool):
        self.engine, self.rec, self.events = engine, rec, events
        self.sched = None
        self.timed: list = []          # (kind, host time, CUDA events)
        self.labels = False
        self.slot_chunks: dict[int, list] = {}

    def _timed(self, kind, fn, *args):
        t = time.perf_counter()
        try:
            return self._labelled(kind, fn, *args)
        finally:
            self.rec.host.append((kind, t, time.perf_counter() - t))

    def _labelled(self, kind, fn, *args):
        if self.labels:
            with torch.profiler.record_function(f"portbench.{kind}"):
                return self._call(kind, fn, *args)
        return self._call(kind, fn, *args)

    def _call(self, kind, fn, *args):
        if not self.events:
            return fn(*args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        self.timed.append((kind, time.perf_counter(), a, b))
        return out

    def decode_fn(self, cache, tokens, active, *extras):
        live = list(self.sched.active)
        pool = self.sched.pool
        resident = int(pool.lengths[live].sum()) + len(live)
        self.rec.ticks.append((time.perf_counter(), len(live), resident))
        return self._timed("decode_fn", self.engine.decode_fn, cache, tokens,
                           active, *extras)

    def chunk_fn(self, cache, tokens, slot, offset, n_valid, kv_bound,
                 *extras):
        call = (time.perf_counter(), int(slot), int(offset), int(n_valid),
                int(tokens.shape[1]))
        self.rec.chunks.append(call)
        if offset == 0:
            self.slot_chunks[int(slot)] = []
        self.slot_chunks.setdefault(int(slot), []).append(call[2:])
        return self._timed("chunk_fn", self.engine.chunk_fn, cache, tokens,
                           slot, offset, n_valid, kv_bound, *extras)

    def times(self) -> None:
        """CUDA-event milliseconds of the window's calls, before a
        profiler started, into the record."""
        torch.cuda.synchronize()
        for kind, t, a, b in self.timed:
            if self.rec.in_quiet(t):
                out = self.rec.tick_ms if kind == "decode_fn" \
                    else self.rec.chunk_ms
                out.append(a.elapsed_time(b))


# ---------------------------------------------------------------------------
# driving


class Driver:
    """The scheduler driven on the wall clock."""

    def __init__(self, engine, cell: Cell, rec: Record, calls: Calls,
                 wrap=None):
        from repro_torch.serving.scheduler import Request, Scheduler, _Entry
        self._Request, self._Entry = Request, _Entry
        decode_fn, chunk_fn = calls.decode_fn, calls.chunk_fn
        if wrap is not None:
            decode_fn, chunk_fn = wrap(decode_fn, chunk_fn)
        self.sched = Scheduler(engine.make_pool(), decode_fn, chunk_fn,
                               eos_id=None, policy="continuous",
                               sampler=None,
                               prefill_chunk=engine.prefill_chunk,
                               prefill_chunk_unit=engine.chunk_unit,
                               vocab_size=engine.cfg.vocab_size)
        calls.sched = self.sched
        self.calls, self.rec, self.cell = calls, rec, cell
        self.done_seen = 0
        self.seen_active: set[int] = set()
        self.steps = 0

    def submit(self, spec: generator.Spec, due: float) -> None:
        req = self._Request(rid=spec.rid, prompt=spec.prompt,
                            max_new_tokens=spec.max_new_tokens)
        self.sched.validate([req])
        r = Req(spec.rid, spec.prompt, due)
        r.release = time.perf_counter()
        self.rec.reqs[spec.rid] = r
        self.sched.queue.append(self._Entry(req))

    def step(self) -> list[Req]:
        """admit_from_queue, one step, then stamp the tokens it made;
        returns the requests it completed."""
        self.sched.admit_from_queue()
        if not self.sched.has_work:
            return []
        t = time.perf_counter()
        self.sched.step()
        self.steps += 1
        now = time.perf_counter()
        self.rec.steps.append((t, now - t))
        for slot, en in self.sched.active.items():
            if en.st.rid not in self.seen_active:
                self.seen_active.add(en.st.rid)
                self.rec.reqs[en.st.rid].chunks = \
                    self.calls.slot_chunks.pop(slot, [])
            self._stamp(en.st, now)
        finished = []
        for st in self.sched.done[self.done_seen:]:
            self._stamp(st, now)
            r = self.rec.reqs[st.rid]
            r.done, r.tokens, r.preemptions = st.t_done, list(st.tokens), \
                st.preemptions
            finished.append(r)
        self.done_seen = len(self.sched.done)
        return finished

    def _stamp(self, st, now: float) -> None:
        r = self.rec.reqs[st.rid]
        if math.isnan(r.admit):
            r.admit = st.t_admit
        n = len(st.tokens)
        if n and not r.times:
            r.first = st.t_first
            r.times.append(st.t_first)
        r.times.extend([now] * (n - len(r.times)))


def _warm_shapes(drv: Driver, chunk: int, vocab: int) -> None:
    """One request a chunk size of the prompt buckets (1, 2, 4, ... up
    to the chunk), two tokens each, through the scheduler; then a fresh
    drain state."""
    rng = np.random.default_rng(0)
    n, rid = 1, -1
    while n <= chunk:
        drv.submit(generator.Spec(rid, rng.integers(0, vocab, n,
                                                    dtype=np.int32), 2),
                   time.perf_counter())
        n, rid = n * 2, rid - 1
    while drv.sched.has_work:
        drv.step()
    drv.sched.reset()
    for log in (drv.rec.reqs, drv.rec.ticks, drv.rec.chunks, drv.rec.host,
                drv.rec.steps, drv.calls.timed):
        log.clear()
    drv.calls.slot_chunks.clear()
    drv.done_seen = 0
    drv.seen_active.clear()


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _read_profile(prof, t_wall: float, ticks: list) -> dict:
    """Device busy time (the union of the device operations' intervals),
    kernel time by name, and idle gaps by what the host was in."""
    from torch.autograd import DeviceType
    evs = prof.events()
    # the labels also show on the device's timeline; they are no work
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and not e.name.startswith("portbench.")]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in evs if e.device_type == DeviceType.CPU
                   and e.name.startswith("portbench."))
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = counts.union_length(iv)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e6
    gaps: dict[str, float] = {}
    end = None
    starts = [s[0] for s in spans]
    for a, b in iv:
        if end is not None and a > end:
            i = int(np.searchsorted(starts, end, side="right")) - 1
            where = "host outside the steps (scheduler, sampling, harness)"
            if i >= 0 and spans[i][0] <= end < spans[i][1]:
                where = f"host inside {spans[i][2][len('portbench.'):]}"
            gaps[where] = gaps.get(where, 0.0) + (a - end) / 1e6
        end = b if end is None else max(end, b)
    return {"busy_s": busy_us / 1e6, "window_s": t_wall,
            "kernel_s": by_name, "gaps_s": gaps, "ticks": ticks}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, wrap=None, log=print, grace_s: float = GRACE_S):
    """One run: (record, engine plan, setup seconds, memory peak).
    ``wrap(decode_fn, chunk_fn)`` may put other steps in the engine's
    place (the tests' faults)."""
    engine = build_engine(cell, seed, device)
    rec = Record(cell.model, engine.num_slots, cell.mix["loop"])
    rec.seconds = seconds
    rec.plan = {"page_size": engine.page_size, "num_pages": engine.num_pages,
                "num_slots": engine.num_slots, "max_len": engine.max_len,
                "prefill_chunk": engine.prefill_chunk,
                "kv_kernel": engine.kv_kernel}
    log(f"[portbench] {time.perf_counter() - t_start:.3f} s: engine built, "
        f"plan {json.dumps(rec.plan)}")
    calls = Calls(engine, rec, events=trace and device == "cuda")
    drv = Driver(engine, cell, rec, calls, wrap)
    _warm_shapes(drv, engine.prefill_chunk, engine.cfg.vocab_size)
    if trace and device == "cuda":
        # the profiler's first start takes seconds (CUPTI); pay it here
        with _profiler():
            torch.cuda.synchronize()
    log(f"[portbench] {time.perf_counter() - t_start:.3f} s: shapes warmed")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    vocab = cell.model["vocab"]
    if cell.mix["loop"] == "closed":
        _closed(drv, cell, seed, seconds, trace, device, vocab)
    else:
        _open(drv, cell, seed, seconds, trace, device, vocab, grace_s)
    setup_s = rec.t_open - t_start
    log(f"[portbench] {setup_s:.3f} s: steady state, window opened")
    log(f"[portbench] window host time: {host_summary(rec)}; the "
        f"profiler took {rec.profile_start_s:.3f} s to start")
    if calls.events:
        calls.times()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    plan = rec.plan
    del drv, calls, engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec, plan, setup_s, peak


def host_summary(rec: Record) -> str:
    """Where the window's host time went: the steps, and inside them
    the calls into the engine's steps (host clock)."""
    steps = [s for t, s in rec.steps if rec.in_window(t)]
    out = [f"{len(steps)} steps {sum(steps):.3f} s (longest "
           f"{max(steps, default=0):.3f})"]
    for kind in ("decode_fn", "chunk_fn"):
        xs = [s for k, t, s in rec.host if k == kind and rec.in_window(t)]
        out.append(f"{len(xs)} {kind} {sum(xs):.3f} s")
    return ", ".join(out)


def _window(drv: Driver, rec: Record, trace: bool, device: str, on_done):
    """Step until the window closes.  Traced, the last TRACE_S seconds of
    the window run under the profiler, whose trace is read once the
    window has closed; the per-layer metrics of the host clock and of
    CUDA events read the part of the window before it."""
    close = rec.t_open + rec.seconds
    traced = trace and device == "cuda"
    prof, p_start, p_tick = None, 0.0, 0
    while True:
        now = time.perf_counter()
        if now >= close:
            break
        if traced and prof is None and now >= close - TRACE_S:
            # the profiler takes seconds to start: the quiet part of the
            # window ends before it
            rec.t_quiet = now
            torch.cuda.synchronize()
            prof = _profiler()
            prof.__enter__()
            drv.calls.labels = True
            p_start, p_tick = time.perf_counter(), len(rec.ticks)
            rec.profile_start_s = p_start - now
        on_done(drv.step(), now)
    if device == "cuda":
        torch.cuda.synchronize()
    rec.t_close = time.perf_counter()
    if not traced or prof is None:
        rec.t_quiet = rec.t_close
    if prof is not None:
        prof.__exit__(None, None, None)
        drv.calls.labels = False
        rec.profile = _read_profile(prof, rec.t_close - p_start,
                                    rec.ticks[p_tick:])


def _closed(drv, cell, seed, seconds, trace, device, vocab) -> None:
    rec = drv.rec
    gen = generator.ClosedLoop(cell.mix, seed, vocab,
                               drv.sched.pool.num_slots)
    first = []
    for _ in range(gen.clients):
        spec = gen.next()
        drv.submit(spec, time.perf_counter())
        first.append(spec.rid)
    wave = first[:drv.sched.pool.num_slots]

    def on_done(finished, now):
        for _ in finished:
            drv.submit(gen.next(), time.perf_counter())

    # steady state: the first wave admitted and past its prefill
    while any(math.isnan(rec.reqs[r].first) for r in wave):
        on_done(drv.step(), None)
    if device == "cuda":
        torch.cuda.synchronize()
    rec.t_open = time.perf_counter()
    _window(drv, rec, trace, device, on_done)


def _open(drv, cell, seed, seconds, trace, device, vocab, grace_s) -> None:
    rec = drv.rec
    specs = generator.open_loop(cell.mix, seed, seconds, vocab)
    warm = float(cell.mix.get("warm_s", 0.0))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter() + warm       # the window opens here
    pending = list(specs)
    sched = drv.sched

    def release(now):
        while pending and t0 + pending[0].due_s <= now:
            spec = pending.pop(0)
            drv.submit(spec, t0 + spec.due_s)

    def on_done(finished, now):
        release(time.perf_counter())

    def idle_until(limit):
        now = time.perf_counter()
        release(now)
        if not sched.has_work and pending:
            time.sleep(max(0.0, min(t0 + pending[0].due_s, limit) - now))
            release(time.perf_counter())

    while time.perf_counter() < t0:
        idle_until(t0)
        if sched.has_work:
            drv.step()
    rec.t_open = t0

    def on_done_window(finished, now):
        release(time.perf_counter())
        if not sched.has_work and pending:
            idle_until(rec.t_open + rec.seconds)

    _window(drv, rec, trace, device, on_done_window)
    # the window's due requests that have no first token yet: wait for
    # them (no later arrivals), at most grace_s
    late = [r for r in rec.due_in_window() if math.isnan(r.first)]
    stop = time.perf_counter() + grace_s
    while late and sched.has_work and time.perf_counter() < stop:
        drv.step()
        late = [r for r in late if math.isnan(r.first)]
