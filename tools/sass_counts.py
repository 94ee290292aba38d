"""Count instructions by kind in the SASS of the port's built kernels.

    python3 tools/sass_counts.py [--match seg_attn_bwd]

Builds the kernels if needed (``warpconvnet_tpu_torch/kernels/_build.py``),
disassembles the library with ``cuobjdump -sass`` and prints one JSON line
per kernel whose (demangled) name contains ``--match``: the count of each
opcode in ``OPS`` (an opcode counts with any suffix, so HGMMA counts
``HGMMA.64x64x8.F32.TF32``), and the distinct full forms of the tensor-core
opcodes seen (which name the operand type, e.g. ``.TF32`` or ``.BF16``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OPS = ("HGMMA", "HMMA", "FFMA", "FMUL", "FADD", "MUFU", "LDS", "STS", "LDG")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--match", default="seg_attn_bwd")
    args = parser.parse_args()
    from warpconvnet_tpu_torch.kernels import _build

    so = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    cufilt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if os.path.exists(cufilt):
            name = subprocess.run([cufilt, name], capture_output=True, text=True).stdout.strip()
        if args.match not in name:
            continue
        opcodes = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]+)", block)
        counts = {op: sum(1 for o in opcodes if o.split(".")[0] == op) for op in OPS}
        forms = sorted({o for o in opcodes if o.split(".")[0] in ("HGMMA", "HMMA")})
        print(json.dumps({"kernel": name, "instructions": len(opcodes), "counts": counts,
                          "tensor_forms": forms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
