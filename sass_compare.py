#!/usr/bin/env python3
"""Compare the SASS of the port's kernel library in two checkouts.

    python3 sass_compare.py PARENT_DIR [CHANGE_DIR]

Builds `grappa_tpu_torch`'s CUDA kernels in each checkout (CHANGE_DIR
defaults to this one), disassembles both libraries with `cuobjdump -sass`
and compares every kernel the two share, instruction by instruction with
operands (addresses left out). Kernel names are matched after dropping
what a change of the GEMM engine's template arguments alters in the
mangled name: the anonymous namespace's hash, the `TcTf32x3` policy tag
(`csrc/tc_gemm.cuh`) and the renumbered substitutions. Prints one line a
kernel that differs or exists on one side only, then the counts; exits 1
when a shared kernel differs. Needs the CUDA toolkit (nvcc, cuobjdump),
so it runs on the machine with the card.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

CUOBJDUMP = '/usr/local/cuda/bin/cuobjdump'


def build(root: str) -> str:
    """The kernel library built in checkout `root`."""
    out = subprocess.run(
        [sys.executable, '-c',
         'from grappa_tpu_torch.ops import _cuda; print(_cuda.build())'],
        cwd=root, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def kernels(so: str) -> dict:
    """{normalised name: [instruction text]} of every function's SASS."""
    sass = subprocess.run([CUOBJDUMP, '-sass', so], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for m in re.finditer(r'Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)',
                         sass, re.S):
        name = re.sub(r'_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+',
                      r'\1', m.group(1))
        name = re.sub(r'ES\d+_T2_', 'ES_T2_',
                      name.replace('NS_8TcTf32x3E', ''))
        out[name] = [re.sub(r'/\*[0-9a-f]{4,}\*/', '', line).split(';')[0]
                     .strip() for line in m.group(2).splitlines()
                     if re.search(r'/\*[0-9a-f]{4,}\*/', line)]
    return out


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    parent = kernels(build(sys.argv[1]))
    change = kernels(build(sys.argv[2] if len(sys.argv) == 3 else here))
    same = differ = 0
    for name, lines in parent.items():
        if name not in change:
            print(f'only in {sys.argv[1]}: {name}')
        elif change[name] == lines:
            same += 1
        else:
            differ += 1
            print(f'differs: {name} ({len(lines)} / {len(change[name])} '
                  f'instructions)')
    new = [n for n in change if n not in parent]
    for name in new:
        print(f'only in the change: {name}')
    print(f'{same} shared kernels identical, {differ} differ; {len(new)} '
          f'only in the change ({sum("wg_gemm_kernel" in n for n in new)} '
          f'of them wg_gemm_kernel instantiations)')
    return 1 if differ else 0


if __name__ == '__main__':
    sys.exit(main())
