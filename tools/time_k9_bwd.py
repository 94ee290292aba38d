"""Time the segment-attention kernels K9 (forward), K9-dkv and K9-dq on the
card, for one checkout of the port or several in turn.

    python3 tools/time_k9_bwd.py                         # this checkout, bf16
    python3 tools/time_k9_bwd.py --dtype fp32
    python3 tools/time_k9_bwd.py --tree A --tree B --tree B --tree A
    python3 tools/time_k9_bwd.py --forward-only          # K9 alone

Each ``--tree`` is the root of a checkout (the directory that holds
``warpconvnet_tpu_torch``); the trees run one after another, each in its
own process, so two versions of the kernels compare on the same card in
one call. Layouts: Volt-s's trunk shape (B 2, S 40960, 6 heads, D 64; the
valid rows the bench scene pair tokenizes to, one segment a scene),
segments of 1024 rows at that shape, and the same at D 16 with 4 heads.
Inputs come from a seeded generator on the card, dO is zero on pad rows.

Prints the card's name and power limit, then one JSON line per tree: per
layout, the mean CUDA-event time of each kernel (K9 with lse, as training
runs it), with ``--dtype fp32`` K9's and the backward's scratch bytes and
the reuse of each row they split (rows their blocks copied in over rows
split), the relative Frobenius error of dq, dk and dv against the plain
backward (with ``--dtype fp32`` also of out, lse, dq, dk and dv against a
float64 plain forward and backward of float64 inputs, beside the fp32
plain versions'), and SHA-1s of out and lse and of the gradients' bytes
(equal digests: the two trees computed the same bits).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

B, S, TOKENS = 2, 40960, (38623, 38539)
ITERS = 10  # timed calls of each kernel (fp32 at the trunk shape: 2)
LAYOUTS = (("global", 6, 64), ("grouped 1024", 6, 64), ("grouped 1024 D 16", 4, 16))


def cuda_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def digest(torch, *tensors):
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def split_reuse(torch, k9, q, k, v, seg):
    """The fp32 forward's scratch bytes, the kv rows it split and its
    blocks copied in (``tracing`` counters ``k9.fwd_split_rows``,
    ``k9.fwd_staged_rows``) and their ratio, the reuse of each split; None
    for a tree without them."""
    from warpconvnet_tpu_torch import tracing

    if not hasattr(k9, "split_scratch"):
        return dict(scratch_bytes=None, split_rows=None, staged_rows=None, split_reuse=None)
    b, skv, h, d = k.shape
    tracing.reset_counters()
    with tracing.recording():
        k9.segment_attention_fwd(q, k, v, seg, seg, return_lse=True)
    got = tracing.counters(q.device)
    split, staged = got["k9.fwd_split_rows"], got["k9.fwd_staged_rows"]
    return dict(scratch_bytes=k9.split_scratch(k9._build.load_library(), b, skv, h, d)[1],
                split_rows=split, staged_rows=staged, split_reuse=staged / split)


def bwd_split_reuse(torch, k9, args):
    """The fp32 backward's scratch bytes as K9-dkv and K9-dq allocated
    them (alive in turn), the visited rows it split and its blocks copied
    in (``tracing`` counters ``k9.bwd_scratch_bytes``,
    ``k9.bwd_split_rows``, ``k9.bwd_staged_rows``) and their ratio; None
    for a tree without them."""
    from warpconvnet_tpu_torch import tracing

    if not hasattr(k9, "bwd_split_scratch"):
        return dict(bwd_scratch_bytes=None, bwd_split_rows=None, bwd_staged_rows=None,
                    bwd_split_reuse=None)
    scratch = []
    tracing.reset_counters()
    with tracing.recording():
        for fn in (k9.segment_attention_bwd_dkv, k9.segment_attention_bwd_dq):
            bytes0 = tracing.counters().get("k9.bwd_scratch_bytes", 0)
            fn(*args)
            scratch.append(tracing.counters()["k9.bwd_scratch_bytes"] - bytes0)
    got = tracing.counters(args[0].device)
    split, staged = got["k9.bwd_split_rows"], got["k9.bwd_staged_rows"]
    return dict(bwd_scratch_bytes=scratch, bwd_split_rows=split, bwd_staged_rows=staged,
                bwd_split_reuse=staged / split)


def run_tree(tree, dtype_name, forward_only):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from warpconvnet_tpu_torch.kernels import segment_attention as k9
    from warpconvnet_tpu_torch.nn.functional.flash_attention import (
        segment_ids_from_groups,
        segment_ids_from_valid,
    )

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    rows = torch.arange(S, device="cuda")[None, :]
    valid = rows < torch.as_tensor(TOKENS, device="cuda")[:, None]
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    for name, h, d in LAYOUTS:
        seg = (segment_ids_from_valid(valid) if name == "global"
               else segment_ids_from_groups(rows // 1024, valid))
        q = (torch.randn((B, S, h, d), generator=gen, device="cuda") * 2.5).to(dtype)
        k, v = (torch.randn((B, S, h, d), generator=gen, device="cuda").to(dtype) for _ in "kv")
        do = (torch.randn((B, S, h, d), generator=gen, device="cuda") * valid[..., None, None]
              ).to(dtype)
        out, lse = k9.segment_attention_fwd(q, k, v, seg, seg, return_lse=True)
        heavy = dtype == torch.float32 and name == "global"
        n = 2 if heavy else ITERS
        fwd_ms = cuda_ms(torch, lambda: k9.segment_attention_fwd(q, k, v, seg, seg,
                                                                  return_lse=True), n)
        case = dict(layout=name, heads=h, d=d, fwd_ms=fwd_ms, fwd_sha1=digest(torch, out, lse))
        if dtype == torch.float32:
            case.update(split_reuse(torch, k9, q, k, v, seg))
        if dtype == torch.float32:
            x64 = [t.double() for t in (q, k, v)]
            o64, lse64 = k9.segment_attention_fwd_plain(*x64, seg, seg, chunk=512,
                                                        return_lse=True)
            o32, lse32 = k9.segment_attention_fwd_plain(q, k, v, seg, seg, return_lse=True)
            finite = torch.isfinite(lse64)

            def fwd64(o, l):
                return [float((o.double() - o64).norm() / o64.norm()),
                        float((l[finite].double() - lse64[finite]).norm()
                              / lse64[finite].norm())]

            case.update(fwd_rel_err_fp64_out_lse=fwd64(out, lse),
                        fwd_plain_rel_err_fp64_out_lse=fwd64(o32, lse32))
            del o32, lse32
        if forward_only:
            cases.append(case)
            continue
        di = k9.rowsum_o_do(out, do)
        args = (q, k, v, do, lse, di, seg, seg)
        dk, dv = k9.segment_attention_bwd_dkv(*args)
        dq = k9.segment_attention_bwd_dq(*args)
        ref = k9.segment_attention_bwd_plain(q, k, v, out, lse, do, seg, seg)
        errs = [float((g.float() - r.float()).norm() / r.float().norm())
                for g, r in zip((dq, dk, dv), ref)]
        fp64 = {}
        if dtype == torch.float32:
            ref64 = k9.segment_attention_bwd_plain(*x64, o64, lse64, do.double(), seg, seg,
                                                   chunk=512)
            del x64, o64, lse64

            def rel64(grads):
                return [float((g.double() - r).norm() / r.norm()) for g, r in zip(grads, ref64)]

            fp64 = dict(rel_err_fp64_dq_dk_dv=rel64((dq, dk, dv)),
                        plain_rel_err_fp64_dq_dk_dv=rel64(ref))
            del ref64
        del ref
        dkv_ms = cuda_ms(torch, lambda: k9.segment_attention_bwd_dkv(*args), n)
        dq_ms = cuda_ms(torch, lambda: k9.segment_attention_bwd_dq(*args), n)
        case.update(dkv_ms=dkv_ms, dq_ms=dq_ms, sum_ms=dkv_ms + dq_ms, rel_err_dq_dk_dv=errs,
                    **fp64, sha1=digest(torch, dq, dk, dv))
        if dtype == torch.float32:
            case.update(bwd_split_reuse(torch, k9, args))
        cases.append(case)
    return dict(tree=tree, dtype=dtype_name, cases=cases)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="root of a checkout; repeat to run several in turn")
    parser.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    parser.add_argument("--forward-only", action="store_true", help="time K9 alone")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:  # one tree, in this process
        print(json.dumps(run_tree(args.tree[0], args.dtype, args.forward_only)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = args.tree or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--tree", tree,
                              "--dtype", args.dtype]
                             + (["--forward-only"] if args.forward_only else [])).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
