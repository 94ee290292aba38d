"""CPU tests of the ``ptv3`` configuration and its cell ``ptv3.train``: its
call table is the work counter's PTv3 table, its pool loses no row to a
level capacity, and a whole run at a CPU scale is ``correct`` when sound
and not when the timed path is broken (the faults of ``test_faults.py``
and a wrong attention backward) or when the control, the reference one
precision down, stands in the program's place.

    python3 -m pytest benchmark/tests/test_ptv3.py -q
"""

import pytest

from benchmark.harness import cell, spec, traffic, work
from benchmark.tests.test_faults import FAULTS, wrong_attention_backward
from benchmark.tests.test_work import ptv3_calls

CELL = "ptv3.train"


def small():
    """The published widths and depths over CPU-sized scenes: n_cap 2048,
    64-row patches, the program in fp32."""
    c = spec.cell(CELL)
    entry = {**c.config["entry"], "kwargs": {"patch_size": 64}}
    cfg = {**c.config, "conv_dtype": "float32", "n_cap": 2048, "patch": 64, "entry": entry}
    return {"config": cfg,
            "traffic": {**c.traffic, "n_points": [500, 900], "pairs": 2, "coord_range": 64}}


def run(faults=None, seed=2 ** 31 + 7):
    return cell.execute(CELL, seed, 0.5, False, "cpu", overrides=small(), faults=faults)


def test_config_calls_are_the_counters_ptv3_table():
    cfg = spec.config("ptv3")
    assert cfg["calls"] == ptv3_calls()
    assert "patch_size" not in cfg and cfg["reduced"] == []
    assert {c["patch"] for c in cfg["calls"] if c["op"] == "patch_attn"} == {cfg["patch"]}
    assert {c["head_dim"] for c in cfg["calls"] if c["op"] == "patch_attn"} == {16}


def test_pool_loses_no_row_to_a_level_capacity():
    c = spec.cell(CELL)
    pool = traffic.make_pool(c.traffic, c.config["in_channels"], 2 ** 31 + 3, "cpu",
                             c.config["n_cap"])
    counts = work.pool_counts(pool, c.config, c.config["n_cap"])
    assert len(counts) == c.traffic["pairs"]
    for entry in counts:
        for sc in entry:
            assert sc["dropped"] == 0 and sc["cells"][4] > 0


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["failed"] == 0


@pytest.mark.parametrize("fault", list(FAULTS["train"]) + ["attention backward"])
def test_broken_timed_path_is_not_correct(fault):
    faults = {**FAULTS["train"], "attention backward": {"step": wrong_attention_backward}}
    out = run(faults[fault])
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    ov = small()
    c = spec.cell(CELL)._replace(config=ov["config"], traffic=ov["traffic"])
    r = cell.Run(c, 11, 0.5, "cpu")
    r.setup()
    r.release_program()
    r.compare("control")
    ok, table = cell.verdict(r.checks, spec.limits(CELL), 0)
    assert not ok, table
