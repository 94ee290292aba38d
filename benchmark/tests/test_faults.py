"""A whole run of each cell on the CPU, at a size a test run can hold,
without the harness's look for a card: a sound run is ``correct``; a run
with its timed path broken underneath (a step that leaves the state
unchanged, half of each batch left out of the step or out of its loss
alone, a wrong attention backward, an answer altered where it is produced)
is not; nor is the control, the plain reference one precision
below the configuration's in the program's place. The cells' own limits
decide. The program runs in fp32 here, so that a sound run reads far below
the limits set for bf16 on the card.

    python3 -m pytest benchmark/tests/test_faults.py -q
"""

import pytest
import torch

from benchmark.harness import cell, spec

SMALL = {"n_points": [500, 900], "pairs": 2, "coord_range": 64}


def small(name):
    c = spec.cell(name)
    cfg = {**c.config, "conv_dtype": "float32", "n_cap": 2048}
    if cfg["model"] == "volt":
        kw = {"token_capacity": 1024, "depth": 2}
        cfg.update(kw, entry={**cfg["entry"], "kwargs": kw})
    return {"config": cfg, "traffic": {**c.traffic, **SMALL}}


def kept(batch: int) -> int:
    """Scenes in the first half of a batch (at least one)."""
    return max(batch // 2, 1)


def first_half(vox):
    k = kept(vox.coords.shape[0])
    return vox.replace(coords=vox.coords[:k], features=vox.features[:k],
                       num_valid=vox.num_valid[:k])


def unchanged(step, model, opt):
    def run(vox, labels):
        before = [p.detach().clone() for p in model.parameters()]
        out = step(vox, labels)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return out
    return run


def half_step(step, model, opt):
    return lambda vox, labels: step(first_half(vox), labels[:kept(labels.shape[0])])


def half_loss(step, model, opt):
    """The forward over the whole batch, the loss from its first half."""
    from warpconvnet_tpu_torch.parallel import train

    whole = train.masked_cross_entropy

    def first_half_only(logits, labels, mask):
        rows = torch.arange(mask.shape[0], device=mask.device) < kept(mask.shape[0])
        return whole(logits, labels, mask & rows[:, None])

    def run(vox, labels):
        train.masked_cross_entropy = first_half_only
        try:
            return step(vox, labels)
        finally:
            train.masked_cross_entropy = whole
    return run


def wrong_attention_backward(step, model, opt):
    """The attention backward's dk and dv left out (K9-dkv's part)."""
    from warpconvnet_tpu_torch.nn.functional import flash_attention as fa

    right = fa.SegmentAttention.backward

    def wrong(ctx, do):
        dq, dk, dv, *rest = right(ctx, do)
        return (dq, torch.zeros_like(dk), torch.zeros_like(dv), *rest)

    def run(vox, labels):
        fa.SegmentAttention.backward = staticmethod(wrong)
        try:
            return step(vox, labels)
        finally:
            fa.SegmentAttention.backward = staticmethod(right)
    return run


def half_forward(forward):
    def run(model, vox):
        out = forward(model, first_half(vox))
        rest = vox.coords.shape[0] - out.shape[0]
        return torch.cat([out, out.new_zeros((rest, *out.shape[1:]))])
    return run


def altered(forward):
    def run(model, vox):
        out = forward(model, vox)
        out[0, 0] = out[0, 0].roll(1)
        return out
    return run


FAULTS = {
    "train": {"state unchanged": {"step": unchanged}, "half batch": {"step": half_step},
              "half loss": {"step": half_loss}},
    "infer": {"half batch": {"forward": half_forward}, "answer altered": {"forward": altered}},
}
CELLS = ["minkunet18.train", "minkunet18.infer", "volt-s.train", "volt-s.infer",
         "minkunet18.train.b8"]


def run(name, faults=None, seed=2 ** 31 + 7):
    return cell.execute(name, seed, 0.5, False, "cpu", overrides=small(name), faults=faults)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["failed"] == 0


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[spec.cell(c).traffic["kind"]]]
                         + [("volt-s.train", "attention backward")])
def test_broken_timed_path_is_not_correct(name, fault):
    faults = {**FAULTS[spec.cell(name).traffic["kind"]],
              "attention backward": {"step": wrong_attention_backward}}
    out = run(name, faults[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    ov = small(name)
    c = spec.cell(name)._replace(config=ov["config"], traffic=ov["traffic"])
    r = cell.Run(c, 11, 0.5, "cpu")
    r.setup()
    if r.kind == "infer":
        r.window()
    r.release_program()
    r.compare("control")
    ok, table = cell.verdict(r.checks, spec.limits(name), 0)
    assert not ok, table
