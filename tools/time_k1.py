"""Time the kernel-map probe K1 on the card, for one checkout of the port or
several in turn.

    python3 tools/time_k1.py                                 # this checkout
    python3 tools/time_k1.py --tree A --tree B --tree B --tree A

Each ``--tree`` is the root of a checkout (the directory that holds
``warpconvnet_tpu_torch``); the trees run one after another, each in its
own process, so two versions of the kernel compare on the same card in one
call. Every tree is timed by the same code: the timing helpers and the
scene builder of this checkout's ``chip_smoke.py``. Shapes: the bench scene
pair of ``chip_smoke.py`` (B 2, n_cap 131072, two surface scenes from seed
0, lex-sorted) probed as its L0 3^3 submanifold map (K 27), the ConvNeXt
block's 7^3 self-map (K 343) and the 7-point cross (K 7, the K5 contract);
then the 7^3 self-map of a denser pair (the same generator on 256 x 256
columns: about 1.7x the voxels a plane), whose windows come near the
shared-memory capacity.

Prints the card's name and power limit, then one JSON line per tree: per
shape, K1's and ``torch.searchsorted``'s (of the formed query keys) time a
call back to back by CUDA events (``ms``, ``searchsorted_ms``; as
``chip_smoke.py`` times every kernel) and their mean device time a call
from a profiler trace (``device_ms``, ``searchsorted_device_ms``; events
time the host's launch rate where the kernel is shorter than its launch),
K1's host time a call to issue (``host_ms``), the share of tiles walked in
device memory because their window did not fit in shared memory (null for
a tree that does not count them), and a SHA-1 of the table (equal digests:
the trees computed the same table); then the step times of ``chip_smoke.py``'s
bf16 MinkUNet18 train step at the bench scale (5 K1 launches a step), the
first step left out.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, STEPS = 20, 9
CROSS = [[1, 0, 0], [0, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0], [0, 1, 0], [0, 0, -1]]


def load_smoke():
    """This checkout's ``chip_smoke.py`` as a module (it imports the port
    only inside its functions, so they run the tree's port)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_step_ms(cs, torch, dev):
    """``chip_smoke.py``'s bf16 MinkUNet18 train step on its bench batch:
    STEPS steps, the first left out."""
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18

    model = MinkUNet18(3, cs.NUM_CLASSES, device=dev, generator=torch.Generator().manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    constants.set_compute_dtype(torch.bfloat16)
    batch = cs.make_batch(7, cs.N_CAP, dev).lex_sort()
    _, ms, _, _ = cs.train_steps(model, state0, batch, cs.labels_for(batch, 8), STEPS, plain=False)
    constants.set_compute_dtype(None)
    return ms[1:]


def run_tree(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from warpconvnet_tpu_torch.kernels import sorted_search
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets
    from warpconvnet_tpu_torch.ops.keys import PAD_COORD, coord_keys

    cs = load_smoke()
    dev = torch.device("cuda", 0)
    counted = hasattr(sorted_search, "probe_tile_counts")
    cases = []
    for name, coord_range, offsets in (
        ("L0 3^3", 512, kernel_offsets(3)), ("7^3", 512, kernel_offsets(7)),
        ("cross", 512, np.array(CROSS, np.int32)), ("7^3 dense", 256, kernel_offsets(7)),
    ):
        vox = cs.make_batch(0, cs.N_CAP, dev, coord_range=coord_range).lex_sort()
        keys = coord_keys(torch.where(vox.valid_mask()[..., None], vox.coords, PAD_COORD))
        args = (keys, vox.num_valid, vox.coords, vox.num_valid, offsets, (1, 1, 1))
        if counted:
            sorted_search.reset_probe_tile_counts()
        table = sorted_search.kernel_map_probe(*args)
        torch.cuda.synchronize()
        share = None
        if counted:
            tiles, wide = sorted_search.probe_tile_counts(dev)
            share = wide / tiles
        h = hashlib.sha1(table.cpu().numpy().tobytes()).hexdigest()
        del table

        def probe():
            sorted_search.kernel_map_probe(*args)

        ms, dev_ms = cs.cuda_ms(probe), cs.device_ms(probe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            probe()
        host_ms = (time.perf_counter() - t0) * 1e3 / ITERS
        torch.cuda.synchronize()
        qk, _ = sorted_search._queries(vox.coords, vox.num_valid, offsets, (1, 1, 1))
        qk = qk.reshape(cs.B, -1).contiguous()
        lib_ms = cs.cuda_ms(lambda: torch.searchsorted(keys, qk))
        lib_dev_ms = cs.device_ms(lambda: torch.searchsorted(keys, qk))
        del qk
        cases.append(dict(shape=name, k=len(offsets), voxels=vox.num_valid.tolist(), ms=ms,
                          device_ms=dev_ms, host_ms=host_ms, searchsorted_ms=lib_ms,
                          searchsorted_device_ms=lib_dev_ms, global_share=share, sha1=h))
    return dict(tree=tree, cases=cases, train_step_ms=train_step_ms(cs, torch, dev))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="root of a checkout; repeat to run several in turn")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:  # one tree, in this process
        print(json.dumps(run_tree(args.tree[0])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rc = 0
    for tree in args.tree or [ROOT]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--tree",
                              tree]).returncode
    print(f"rc={rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
