"""Count the instructions of a kernel's hot loop by kind, from its SASS.

    python3 hail_tpu_torch/csrc/bench/sass_count.py SOURCE.cu NAME ENTRIES \\
        [--dump=FILE] [nvcc options ...]

Compiles SOURCE.cu to a cubin for sm_90a (nvcc -O3 and the options given),
disassembles it with `cuobjdump -sass`, takes the function whose
mangled name holds NAME (the one with the most FFMAs if several do), and in
it the loop, a backward branch and its target, that holds the most FFMAs.
Prints the loop's instruction counts by kind and, divided by ENTRIES (the
matrix entries one lane covers in one trip of that loop), the instructions
per entry; then the same for the loop's longest stretch without a branch,
with the entries in proportion to its FFMAs. Where the loop holds a
straight-line body and a checked copy of it for the ragged end, the stretch
is what runs and the loop counts both (give ENTRIES for both). --dump=FILE
writes the loop's instructions there.

K1 (linreg_f32.cu, kernel name ILi5ELi4ELb1E for five columns, four rows a
warp, aligned rows): a trip is one staged tile in both copies of its body,
ENTRIES = 2 x rows per warp x samples per tile / 32 = 256.
"""

import collections
import os
import re
import subprocess
import sys
import tempfile

KINDS = (('ffma_fadd', ('FFMA', 'FADD', 'FMUL')),
         ('conversion', ('I2F', 'I2FP', 'F2F', 'F2I', 'I2I')),
         ('lds', ('LDS',)),
         ('ldg', ('LDG', 'LD.')),
         ('integer_logic', ('IMAD', 'IADD', 'LOP', 'SHF', 'PRMT', 'IDP',
                            'LEA', 'ISETP', 'SEL', 'MOV', 'IABS', 'SGXT',
                            'BFE', 'BFI', 'PLOP', 'IMNMX', 'VIMNMX', 'UIADD',
                            'ULOP', 'USHF', 'UMOV', 'UIMAD', 'ULEA', 'UISETP',
                            'USEL', 'UPRMT', 'R2UR', 'S2R', 'S2UR', 'CS2R',
                            'POPC', 'FSEL', 'FSETP', 'P2R', 'R2P')))


def kind_of(op):
    for kind, prefixes in KINDS:
        if op.startswith(prefixes):
            return kind
    return 'other'


def functions(sass):
    """{name: [(address, opcode, text)]} of a cuobjdump -sass listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?);', line)
        if m and cur is not None:
            text = re.sub(r'^@!?U?P\d+\s+', '', m.group(2).strip())
            cur.append((int(m.group(1), 16), text.split()[0], text))
    return out


def hot_loop(instrs):
    """The instructions between a backward branch's target and the branch
    that hold the most FFMAs."""
    best = []
    for addr, op, text in instrs:
        m = re.search(r'\b0x([0-9a-f]+)\b', text) if op.startswith('BRA') else None
        if m and int(m.group(1), 16) <= addr:
            body = [i for i in instrs if int(m.group(1), 16) <= i[0] <= addr]
            if (sum(i[1].startswith('FFMA') for i in body)
                    > sum(i[1].startswith('FFMA') for i in best)):
                best = body
    return best


def straight(loop):
    """The longest stretch of the loop with no branch in it."""
    best, cur = [], []
    for ins in loop:
        if ins[1].startswith(('BRA', 'BSSY', 'BSYNC', 'EXIT', 'CALL', 'RET')):
            best, cur = max(best, cur, key=len), []
        else:
            cur.append(ins)
    return max(best, cur, key=len)


def report(title, instrs, entries):
    counts = collections.Counter(kind_of(op) for _, op, _ in instrs)
    ops = collections.Counter(op.split('.')[0] for _, op, _ in instrs)
    total = sum(counts.values())
    print(f'  {title}: {total} instructions at {instrs[0][0]:#x}-'
          f'{instrs[-1][0]:#x}, {entries:g} entries')
    print('    ' + ', '.join(f'{kind} {counts[kind]} = '
                             f'{counts[kind] / entries:.3f}'
                             for kind in [k for k, _ in KINDS] + ['other']))
    print(f'    all: {total / entries:.3f} per entry; FFMA share '
          f'{ops["FFMA"] / total:.3f}')
    print('    opcodes: ' + ', '.join(f'{o} {n}' for o, n in ops.most_common()))


def main(argv):
    if len(argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    dump = [a for a in argv if a.startswith('--dump=')]
    argv = [a for a in argv if a not in dump]
    src, name, entries = argv[1], argv[2], float(argv[3])
    cuda = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, 'k.cubin')
        subprocess.run([os.path.join(cuda, 'bin', 'nvcc'), '-gencode',
                        'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                        *argv[4:], '-cubin', '-o', cubin, src], check=True)
        sass = subprocess.run([os.path.join(cuda, 'bin', 'cuobjdump'), '-sass',
                               cubin], check=True, capture_output=True,
                              text=True).stdout
    found = {f: i for f, i in functions(sass).items() if name in f}
    if not found:
        print(f'no function named *{name}* in {src}', file=sys.stderr)
        return 1
    fn, instrs = max(found.items(), key=lambda kv: sum(
        i[1].startswith('FFMA') for i in kv[1]))
    loop = hot_loop(instrs)
    if not loop:
        print(f'{fn}: no loop with FFMAs', file=sys.stderr)
        return 1
    if dump:
        with open(dump[0][len('--dump='):], 'w') as f:
            f.writelines(f'{a:#06x} {t}\n' for a, _, t in loop)
    print(f'{os.path.basename(src)} {" ".join(argv[4:])}: {fn} '
          f'({len(instrs)} instructions)')
    report('hot loop', loop, entries)
    run = straight(loop)
    ffma = sum(i[1].startswith('FFMA') for i in run)
    all_ffma = sum(i[1].startswith('FFMA') for i in loop)
    report('its longest stretch without a branch', run,
           entries * ffma / max(all_ffma, 1))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
