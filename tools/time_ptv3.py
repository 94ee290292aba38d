"""Time Point Transformer V3's kernel shapes on the card at the benchmark's
scale: the bench scene pair (B 2, n_cap 262144 rows a scene) at its five
levels (stride-2 grid max pooling, as the model pools).

    python3 tools/time_ptv3.py

Per level: K9 (fp32, with lse, as training runs it), K9-dkv and K9-dq at
head size 16 over 1024-row patches of the level's valid rows in Morton
order, the pad rows on their own segment ids (``patch_segment_ids``), by
CUDA events (``chip_smoke.cuda_ms``) beside the bound the benchmark's work
counter gives them (its useful FLOPs over the 3xTF32 rate, its bytes over
the HBM rate), and the kv tiles K9 visits over those of the valid rows
alone; then K2 and K4 (bf16) on the 5^3 stem map (C 6 -> 32) and on each
level's 3^3 map at its positional conv's width. Prints the card's name and
power limit, then one JSON line an entry and ``{"ok": true}`` last.
"""

from __future__ import annotations

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from benchmark.harness import work  # noqa: E402

def attention_entry(lv, v, k9):
    from warpconvnet_tpu_torch.nn.functional.flash_attention import patch_segment_ids
    from warpconvnet_tpu_torch.nn.modules.attention import serialize_patches

    c = cs.PTV3_WIDTHS[lv]
    h, n = c // 16, v.max_num_points
    gen = torch.Generator(device="cuda").manual_seed(lv)
    q, k, vv, do = (torch.randn((2, n, h, 16), generator=gen, device="cuda") for _ in "qkvd")
    seg_q, seg_kv = patch_segment_ids(v.num_valid, n, cs.PTV3_PATCH)
    valid = seg_q == seg_kv
    do = torch.where(valid[..., None, None], do, 0)
    perm, _ = serialize_patches(v.coords, v.num_valid)
    serial_ms = cs.cuda_ms(lambda: serialize_patches(v.coords, v.num_valid))
    out, lse = k9.segment_attention_fwd(q, k, vv, seg_q, seg_kv, return_lse=True)
    di = k9.rowsum_o_do(out, do)
    fwd = cs.cuda_ms(lambda: k9.segment_attention_fwd(q, k, vv, seg_q, seg_kv, return_lse=True),
                     iters=5)
    dkv = cs.cuda_ms(lambda: k9.segment_attention_bwd_dkv(q, k, vv, do, lse, di, seg_q, seg_kv),
                     iters=5)
    dq = cs.cuda_ms(lambda: k9.segment_attention_bwd_dq(q, k, vv, do, lse, di, seg_q, seg_kv),
                    iters=5)
    nv = v.num_valid.tolist()
    f = b = 0.0
    for m in nv:
        (_, ff, bb), (_, fb, bbw) = work._patch_attn(m, cs.PTV3_PATCH, h, 16, 4, True)
        f, b = f + ff, b + bb
    bound_fwd = max(f / cs.TF32X3_FLOPS, b / cs.HBM_BYTES_PER_S) * 1e3
    visited, _ = k9.kv_tiles_visited(seg_q, seg_kv)
    alone = sum(k9.kv_tiles_visited(seg_q[s:s + 1, :m], seg_kv[s:s + 1, :m])[0]
                for s, m in enumerate(nv))
    del perm
    return {"level": lv, "rows": n, "valid": nv, "heads": h, "serialize_ms": serial_ms,
            "k9_ms": fwd, "k9_dkv_ms": dkv, "k9_dq_ms": dq, "k9_bound_ms": bound_fwd,
            "bwd_bound_ms": 2 * bound_fwd, "kv_tiles": visited, "kv_tiles_valid_alone": alone}


def conv_entry(label, v, ks, c_in, c_out):
    from warpconvnet_tpu_torch.kernels import implicit_gemm
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map)

    _, _, sub, _ = generate_output_coords_and_kernel_map(v, ks)
    sub = sub.with_orders()
    gen = torch.Generator(device="cuda").manual_seed(ks)
    kk = ks ** 3
    x = torch.randn((2, v.max_num_points, c_in), generator=gen, device="cuda")
    x = torch.where(v.valid_mask()[..., None], x, 0).to(torch.bfloat16)
    w = (torch.randn((kk, c_in, c_out), generator=gen, device="cuda") / (kk * c_in) ** 0.5
         ).to(torch.bfloat16)
    g = torch.randn((2, v.max_num_points, c_out), generator=gen, device="cuda").to(torch.bfloat16)
    fwd = cs.cuda_ms(lambda: implicit_gemm.implicit_gemm_fwd(x, w, sub.table, order=sub.order))
    bwd = cs.cuda_ms(lambda: implicit_gemm.implicit_gemm_bwd_fused(
        x, g, w, sub.table, sub.offsets, order=sub.order))
    pairs = int((sub.table >= 0).sum())
    n = int(v.num_valid.sum())
    (_, ff, fb), (_, bf, bb) = work._table_conv(n, pairs, kk, c_in, c_out, 2, True)
    return {"conv": label, "pairs": pairs, "k2_ms": fwd, "k4_ms": bwd,
            "k2_bound_ms": max(ff / cs.PEAK_FLOPS[torch.bfloat16], fb / cs.HBM_BYTES_PER_S) * 1e3,
            "k4_bound_ms": max(bf / cs.PEAK_FLOPS[torch.bfloat16], bb / cs.HBM_BYTES_PER_S) * 1e3}


def main() -> int:
    from warpconvnet_tpu_torch.kernels import segment_attention as k9

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"card: {cs.card_name()}")
    vox = cs.make_batch(0, cs.PTV3_N_CAP, "cuda", channels=cs.PTV3_IN).lex_sort()
    lv = cs.ptv3_levels(vox)
    for i, v in enumerate(lv):
        print(json.dumps(attention_entry(i, v, k9)), flush=True)
    print(json.dumps(conv_entry("stem 5^3 L0", vox, 5, 6, 32)), flush=True)
    for i, v in enumerate(lv):
        c = cs.PTV3_WIDTHS[i]
        print(json.dumps(conv_entry(f"xCPE 3^3 L{i}", v, 3, c, c)), flush=True)
    print(json.dumps({"ok": True, "card": cs.card_name(), "state": cs.card_state()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
