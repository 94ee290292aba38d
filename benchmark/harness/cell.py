"""One run of one cell: set-up, the measured window, an optional profiled
slice, the comparison that decides ``correct``, and the result line.

Train cells: set-up builds the model from the seed's weights, its Adam
and the program's train step, and drives that one object through its
first ``COMPARED_STEPS`` steps through the window's own call and feed;
their losses, the head's logits of the first and of the last of them,
the first gradient (read from Adam's state after step 1) and the
parameters' change over them are kept. The window then runs
steps back to back. Afterwards the program is freed and the plain
reference takes the same three steps from the same weights.

Infer cells: set-up warms up on two requests; the window answers requests
one at a time (closed loop, one client), each timed from its start to its
synchronise, and keeps the answers of a seeded sample with the pool's
longest batch among them. Afterwards the reference answers the sampled
requests.
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import measure, program, spec, traffic, weights, work

COMPARED_STEPS = 3  # unless the configuration sets "compared_steps"
WARMUP_REQUESTS = 2
EXCLUDE_BELOW = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def _loadavg() -> str:
    try:
        return "%.2f" % os.getloadavg()[0]
    except OSError:
        return "n/a"


class Context:
    """What a metric's reader sees (``benchmark/metrics/<name>.py``)."""

    def __init__(self, kind, config, mix):
        self.kind = kind
        self.config = config
        self.traffic = mix
        self.setup_s = 0.0
        self.window_s = 0.0
        self.items = 0
        self.voxels = 0
        self.flops = 0.0
        self.issue_s: List[float] = []
        self.latency_s: List[float] = []
        self.peak_window_bytes = 0
        self.trace: Optional[measure.Trace] = None
        self.traced_work: List[tuple] = []
        self.traced_s = 0.0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _gap(a: float, r: float, scale: float) -> float:
    """|a - r| / scale; infinite where either side is not finite."""
    if not (math.isfinite(a) and math.isfinite(r)):
        return math.inf
    return abs(a - r) / scale if scale > 0 else (0.0 if a == r else math.inf)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _logit_rel(got: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """||got - ref|| / ||ref|| over every scene's rows; a scene missing from
    ``got`` (or of the wrong size) counts as all zeros."""
    diff = ref_sq = 0.0
    for s, r in enumerate(ref):
        g = got[s] if s < len(got) and got[s].shape == r.shape else torch.zeros_like(r)
        diff += float((g - r).square().sum())
        ref_sq += float(r.square().sum())
    return _finite(math.sqrt(diff / ref_sq)) if ref_sq > 0 else math.inf


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], ref_grad: Dict[str, float]):
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; leaves whose reference gradient is under ``EXCLUDE_BELOW`` of
    the median leaf's are left out. Returns ({leaf: gap}, excluded)."""
    med_grad = statistics.median(ref_grad.values())
    keep = [k for k in ref if ref_grad[k] >= EXCLUDE_BELOW * med_grad]
    med = statistics.median(ref[k] for k in keep)
    return {k: _gap(prog[k], ref[k], max(ref[k], med)) for k in keep}, len(ref) - len(keep)


class Run:
    """One cell run. ``faults`` (tests only) breaks the timed path:
    ``{"step": f(step, model, optimizer) -> step}`` or ``{"forward":
    f(forward) -> forward}``."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, device="cuda",
                 t_start: Optional[float] = None, faults=None):
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.traffic
        self.kind = self.mix["kind"]
        self.n_cap = self.cfg["n_cap"]
        self.seed = seed
        self.seconds = seconds
        self.device = torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.faults = faults or {}
        self.ref = spec.reference(self.cfg)
        self.ctx = Context(self.kind, self.cfg, self.mix)
        self.checks: Dict[str, float] = {}
        self.seen = 0
        self.notes: List[str] = []
        self.failed = 0

    # ---- set-up ------------------------------------------------------------

    def setup(self):
        cfg, mix, dev = self.cfg, self.mix, self.device
        program.set_compute_dtype(cfg)
        self.pool = traffic.make_pool(mix, cfg["in_channels"], self.seed, dev, self.n_cap)
        self.counts = work.pool_counts(self.pool, cfg, self.n_cap)
        dropped = sum(sc["dropped"] for entry in self.counts for sc in entry)
        if dropped:
            raise ValueError(f"{self.cell.name}: the configuration's capacities drop {dropped} rows "
                             "of the pool; the cell would time less than the model's work")
        flipped = work.flip_dependent(self.counts)
        if flipped:
            raise ValueError(f"{self.cell.name}: the feed's flips change the window sums of "
                             f"{len(flipped)} (scene, level, window) of the pool, so its counts "
                             f"would not hold for every item; first: {flipped[0]}")
        train = self.kind == "train"
        self.entry_work = [(work.voxels(c), work.model_flops(c, cfg, train)) for c in self.counts]
        self.feed = traffic.Feed(self.pool, mix, self.seed)
        self.model = program.build(cfg, dev)
        weights.load_into(self.model, weights.make(self.ref.param_spec(cfg), self.seed, dev))
        self.label_gen = traffic.torch_generator(self.seed, 6, dev)
        if self.kind == "train":
            self._setup_train()
        else:
            self._setup_infer()
        _sync(dev)
        self.setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        self.ctx.setup_s = time.perf_counter() - self.t_start

    def _train_item(self, i):
        item = self.feed(i)
        labels = traffic.labels(self.label_gen, self.mix["batch"], self.n_cap,
                                self.cfg["num_classes"], self.mix["label_skew"], self.device)
        return item, labels

    def _setup_train(self):
        step, opt = program.train_step(self.model, self.cfg)
        if "step" in self.faults:
            step = self.faults["step"](step, self.model, opt)
        self.step = step
        self.opt = opt
        params = dict(self.model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in params.items()}
        self.compared = []
        self.prog_loss = []
        n_steps = self.cfg.get("compared_steps", COMPARED_STEPS)
        head = self.model.get_submodule(self.cfg["logits_module"])
        seen = []
        hook = head.register_forward_hook(lambda m, i, o: seen.append(o[0].features.detach().clone()))
        for i in range(n_steps):
            item, labels = self._train_item(i)
            out = self.step(program.voxels(item, self.device), labels)
            self.prog_loss.append(out["loss"].float())
            self.compared.append((item, labels))
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                g = {k: (opt.state[p]["exp_avg"] / (1 - beta1)).norm() if p in opt.state
                     else torch.zeros((), device=self.device) for k, p in params.items()}
        hook.remove()
        # The head's logits of the first and the last compared step's forward
        # (none where a step ran no forward through it).
        self.prog_logits = (seen[0], seen[-1]) if len(seen) == n_steps else (None, None)
        self.prog_grad = {k: float(v) for k, v in g.items()}
        self.prog_change = {k: float((params[k].detach() - p0[k]).norm()) for k in params}
        self.prog_loss = [float(v) for v in self.prog_loss]
        del p0
        self.next_index = n_steps

    def _setup_infer(self):
        self.model.eval()
        for i in range(WARMUP_REQUESTS):
            with torch.inference_mode():
                program.forward(self.model, program.voxels(self.feed(i), self.device))
        self.next_index = WARMUP_REQUESTS
        sizes = [sum(s) for s in self.pool.sizes]
        self.longest_entry = int(np.argmax(sizes))
        self.kept: Dict[int, tuple] = {}
        self.sample_rng = traffic.rng(self.seed, 7)

    # ---- the window --------------------------------------------------------

    def window(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        finite = torch.zeros((), dtype=torch.int64, device=self.device)
        run = self._train_once if self.kind == "train" else self._infer_once
        ctx = self.ctx
        load0 = _loadavg()
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.seconds:
            finite += run(self.next_index, ctx)
            self.next_index += 1
        _sync(self.device)
        ctx.window_s = time.perf_counter() - t0
        # Whether the host held the window back: this process's CPU seconds
        # over the window's (under 1 where it waited on the card or on a CPU
        # taken by others) and the host's load at the window's ends.
        self.host_note = (f"host: process cpu / window {(time.process_time() - cpu0) / ctx.window_s:.3f}; "
                          f"load average {load0} -> {_loadavg()}; card {measure.card_state()}")
        self.failed = ctx.items - int(finite)
        if self.device.type == "cuda":
            ctx.peak_window_bytes = torch.cuda.max_memory_allocated()

    def _count(self, entry, ctx):
        voxels, flops = self.entry_work[entry]
        ctx.items += 1
        ctx.voxels += voxels
        ctx.flops += flops

    def _train_once(self, i, ctx):
        item, labels = self._train_item(i)
        vox = program.voxels(item, self.device)
        a = time.perf_counter()
        out = self.step(vox, labels)
        ctx.issue_s.append(time.perf_counter() - a)
        self._count(item.entry, ctx)
        return torch.isfinite(out["loss"]).to(torch.int64)

    def _infer_once(self, i, ctx, keep=True):
        item = self.feed(i)
        forward = program.forward
        if "forward" in self.faults:
            forward = self.faults["forward"](forward)
        a = time.perf_counter()
        with torch.inference_mode():
            logits = forward(self.model, program.voxels(item, self.device))
        b = time.perf_counter()
        _sync(self.device)
        ctx.latency_s.append(time.perf_counter() - a)
        ctx.issue_s.append(b - a)
        self._count(item.entry, ctx)
        if keep:
            self.seen += 1
            self._keep(item, logits, self.seen)
        return torch.isfinite(logits).all().to(torch.int64)

    def _keep(self, item, logits, n_seen):
        """A reservoir sample of ``check_requests`` answers, and the first
        answer to the pool's longest batch."""
        k = self.cfg["check_requests"]
        key = None
        if item.entry == self.longest_entry and "longest" not in self.kept:
            key = "longest"
        elif n_seen <= k:
            key = n_seen - 1
        else:
            j = int(self.sample_rng.integers(0, n_seen))
            key = j if j < k else None
        if key is not None:
            self.kept[key] = (item, logits.clone())

    # ---- the profiled slice ------------------------------------------------

    def traced_slice(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        n = self.cfg["trace_items"][self.kind]
        ctx = Context(self.kind, self.cfg, self.mix)
        name = "bench.step" if self.kind == "train" else "bench.request"
        _sync(self.device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                with record_function(name):
                    if self.kind == "train":
                        self._train_once(self.next_index, ctx)
                    else:
                        self._infer_once(self.next_index, ctx, keep=False)
                self.next_index += 1
            _sync(self.device)
            self.ctx.traced_s = time.perf_counter() - t0
        self.ctx.trace = measure.read_trace(prof)
        self.ctx.traced_work = []
        first = self.next_index - n
        for i in range(first, self.next_index):
            self.ctx.traced_work += work.batch_work(
                self.counts[self.feed.entry(i)], self.cfg, self.kind == "train")

    # ---- correctness -------------------------------------------------------

    def release_program(self):
        for name in ("model", "step", "opt"):
            if hasattr(self, name):
                delattr(self, name)
        _free()

    def compare(self, precision: str = "reference"):
        """The numbers compared, against the reference. For calibrating the
        limits, ``precision`` "control" puts the reference one precision down
        in the program's place, and (train cells) "half_batch" the reference
        stepping on half of each batch, "half_loss" the reference taking the
        loss from half of each batch after a forward over all of it."""
        self.checks, self.notes = {}, []
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.kind == "train":
            self._compare_train(precision)
        else:
            self._compare_infer(precision)

    def _tf32(self, precision: str):
        """TF32 products for the control where the configuration asks
        (``control_tf32``: its fp32 parts one step down), forward and
        backward alike."""
        on = precision == "control" and self.cfg.get("control_tf32", False)
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    def _ref_params(self, grad: bool):
        p = weights.make(self.ref.param_spec(self.cfg), self.seed, self.device)
        for v in p.values():
            v.requires_grad_(grad)
        return p

    def _ref_steps(self, precision: str, half: str = ""):
        """(losses, first gradient norms, change norms, the first and the
        last step's logits) of the reference taking the compared steps
        under ``precision``. Faults to calibrate against: ``half`` "batch"
        steps on the first half of each batch's scenes only; "loss" runs
        the forward on the whole batch and takes the loss from its first
        half only."""
        self._tf32(precision)
        params = self._ref_params(True)
        p0 = {k: v.detach().clone() for k, v in params.items()}
        opt = torch.optim.Adam(params.values(), lr=self.cfg["optimizer"]["lr"])
        losses, grad, seen = [], None, []
        for item, labels in self.compared:
            scenes = traffic.scenes_of(item)
            kept = max(len(scenes) // 2, 1)
            if half == "batch":
                scenes = scenes[:kept]
            logits = self.ref.forward(params, scenes, self.cfg, self.n_cap, True, precision)
            seen.append([x.detach() for x in logits])
            lossed = logits[:kept] if half == "loss" else logits
            lab = torch.cat([labels[s, :x.shape[0]] for s, x in enumerate(lossed)])
            loss = torch.nn.functional.cross_entropy(torch.cat(lossed), lab)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if grad is None:
                grad = {k: float(v.grad.norm()) for k, v in params.items()}
            opt.step()
            losses.append(float(loss.detach()))
            del logits, loss
        change = {k: float((v.detach() - p0[k]).norm()) for k, v in params.items()}
        self._tf32("reference")
        return losses, grad, change, (seen[0], seen[-1])

    def _compare_train(self, precision):
        if not hasattr(self, "_reference_steps"):
            self._reference_steps = self._ref_steps("reference")
        losses, grad, change, logits = self._reference_steps
        if precision == "control":
            got_loss, got_grad, got_change, got_logits = self._ref_steps("control")
        elif precision in ("half_batch", "half_loss"):
            got_loss, got_grad, got_change, got_logits = self._ref_steps(
                "reference", half=precision[5:])
        else:
            got_loss, got_grad, got_change = self.prog_loss, self.prog_grad, self.prog_change
            got_logits = [[] if y is None else [y[s, :x.shape[0]].float()
                                                for s, x in enumerate(ref) if s < y.shape[0]]
                          for y, ref in zip(self.prog_logits, logits)]
        self.checks["logit1_rel"] = _logit_rel(got_logits[0], logits[0])
        self.checks["logit_last_rel"] = _logit_rel(got_logits[1], logits[1])
        gaps = [_gap(a, r, abs(r)) for a, r in zip(got_loss, losses)]
        self.checks["loss_gap"] = max(gaps)
        self.checks["loss1_gap"] = gaps[0]
        for name, got, ref in (("grad_gap", got_grad, grad), ("change_gap", got_change, change)):
            per, excl = leaf_gaps(got, ref, grad)
            worst = max(per, key=per.get)
            self.checks[name] = per[worst]
            self.checks[f"{name}_median"] = statistics.median(per.values())
            self.notes.append(f"{name} worst leaf {worst}; {excl} leaves left out")
        self.notes.append("losses compared/reference: " + ", ".join(
            f"{a:.6g}/{r:.6g}" for a, r in zip(got_loss, losses)))

    def _compare_infer(self, precision):
        params = self._ref_params(False)
        rel, row = 0.0, 0.0
        with torch.no_grad():
            for key, (item, logits) in sorted(self.kept.items(), key=lambda kv: str(kv[0])):
                scenes = traffic.scenes_of(item)
                ref = self.ref.forward(params, scenes, self.cfg, self.n_cap, False)
                if precision == "control":
                    self._tf32("control")
                    got = self.ref.forward(params, scenes, self.cfg, self.n_cap, False,
                                           "control")
                    self._tf32("reference")
                else:
                    got = [logits[s, :c.shape[0]].float() for s, (c, _) in enumerate(scenes)]
                r, g = torch.cat(ref), torch.cat(got)
                d = g - r
                rel = max(rel, _finite(float(d.norm() / r.norm())))
                row = max(row, _finite(float(d.norm(dim=1).max() / r.norm(dim=1).median())))
                self.notes.append(f"request {key}: reference logits rms {float(r.square().mean().sqrt()):.4g}")
        self.checks["logit_rel"] = rel
        self.checks["row_gap"] = row
        self.notes.append(f"{len(self.kept)} requests compared")

    # ---- the result --------------------------------------------------------

    def device_info(self) -> dict:
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": 1, "memory_peak_bytes": max(self.setup_peak, self.ctx.peak_window_bytes)}


def verdict(checks: Dict[str, float], limits: Optional[dict], failed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name; without limits nothing is correct."""
    if limits is None:
        return False, {k: {"value": v, "limit": None} for k, v in checks.items()}
    table = {k: {"value": checks.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    ok = failed == 0 and all(math.isfinite(e["value"]) and e["value"] <= e["limit"]
                             for e in table.values())
    return ok, table


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: Optional[float] = None, overrides: Optional[dict] = None,
            faults=None) -> dict:
    """A whole run; returns the result line's object. ``overrides``
    (tests) replaces keys of the configuration and the mix."""
    cell = spec.cell(cell_name)
    if overrides:
        cell = cell._replace(config={**cell.config, **overrides.get("config", {})},
                             traffic={**cell.traffic, **overrides.get("traffic", {})})
    run = Run(cell, seed, seconds, device, t_start, faults)
    run.setup()
    run.window()
    if trace:
        run.traced_slice()
    dev_info = run.device_info()
    if trace:
        dev_info["busy_s"] = run.ctx.trace.busy_s()
        dev_info["window_s"] = run.ctx.traced_s
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(run.ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run.release_program()
    t_ref = time.perf_counter()
    run.compare()
    run.notes.append(f"reference {time.perf_counter() - t_ref:.1f} s")
    try:
        limits = spec.limits(cell_name)
    except FileNotFoundError:
        limits = None
    correct, table = verdict(run.checks, limits, run.failed)
    for note in [run.host_note] + run.notes:
        print(note, file=sys.stderr)
    for name, value in run.checks.items():
        if name not in table:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, entry in table.items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    out = {"correct": correct, "attempted": run.ctx.items, "failed": run.failed,
           "metrics": metrics, "device": dev_info}
    if trace:
        out["breakdown"] = measure.breakdown(run.ctx.trace)
    out["checks"] = table
    return out
