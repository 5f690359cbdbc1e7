"""The instruction-issue floor of a kernel's slot loops, from its SASS.

    python -m qamreconciliation_tpu_torch.sims.sass_floor SASS FUNCTION \\
        --elements N [--ilp SLOTS]

``SASS`` is ``cuobjdump -sass`` output (``chip_smoke.py --sass DIR`` writes
one a library into DIR), ``FUNCTION`` a substring of the kernel's mangled
name (``check_major_tile_kernelIfE`` for kernel 5's float32 instance,
``check_major_tile_kernelI13__nv_bfloat16E`` for bf16;
``check_math_kernelIfLi0ELi6ELb1E`` for kernel 6's float32 phi at dc 6 on
its bulk path).  The slot loops are the innermost loops that issue MUFU
instructions other than MUFU.RCP (the transcendental chains; an integer
division by a value known only at run time issues a MUFU.RCP too, as
kernel 6's producer loops do); an iteration of each runs
``--ilp`` slots (default ``ops.kernels.CM_ILP``: kernel 5 runs one slot of
that many (check, frame) pairs in lockstep, and holds each pass's loop
once; kernel 6's register instances run a pair's dc slots, both passes,
in one iteration of one loop, so ``--ilp`` is dc there).  Their
common path leaves out the phi rule's large-argument regime (the block
that a branch on an ``FSETP`` against 10 jumps over), which the slots
rarely take.  The floor is the time the warp schedulers of the H100 SXM
(``ops.kernels.H100_SMS`` SMs, 4 schedulers an SM, one instruction a
cycle each) take to issue that path once for each of ``elements`` slots,
32 lanes a warp instruction, at the ``CLOCK_GHZ`` maximum SM clock: a
lower bound of the kernel's time that ignores every other instruction,
stall and memory access.
"""

from __future__ import annotations

import argparse
import re

from ..ops.kernels import CM_ILP, H100_SMS

__all__ = ["CLOCK_GHZ", "parse_function", "slot_loops", "common_path",
           "issue_floor_ms", "floor_of", "main"]

CLOCK_GHZ = 1.98            # the H100 SXM's 1980 MHz maximum SM clock

_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"BRA (?:`\()?0x([0-9a-f]+)")
# a predicate set by a compare, and the phi regime's compare against 10
_SETP = re.compile(r"(?:@!?P\d )?[FIDH]?SETP\S* (P\d),")
_REGIME = re.compile(r"FSETP\.GEU?\.AND (P\d), PT, R\d+, 10,")
# a transcendental MUFU: any but the reciprocal of an integer division
_MUFU = re.compile(r"MUFU\.(?!RCP )")


def parse_function(sass: str, name: str):
    """[(address, instruction)] of the first function whose header holds
    ``name``."""
    out, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = name in line
            continue
        m = _INSTR.match(line) if inside else None
        if m:
            out.append((int(m.group(1), 16), m.group(2)))
    if not out:
        raise ValueError(f"no function matching {name!r} in the SASS")
    return out


def slot_loops(instrs):
    """The innermost transcendental loops as (first, last) address pairs:
    backward branches whose range holds a MUFU instruction other than
    MUFU.RCP and no smaller such range."""
    loops = []
    for addr, text in instrs:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            if any(lo <= a <= addr and _MUFU.search(t) for a, t in instrs):
                loops.append((lo, addr))
    return sorted(r for r in loops
                  if not any(o != r and r[0] <= o[0] and o[1] <= r[1]
                             for o in loops))


def common_path(instrs, loop):
    """Instructions of ``loop`` on its common path: every one but those a
    phi regime test branches around (``@!P BRA T`` where P was last set by
    an ``FSETP`` against the immediate 10)."""
    lo, hi = loop
    body = [(a, t) for a, t in instrs if lo <= a <= hi]
    regime, skipped = {}, set()
    for addr, text in body:
        m = _SETP.match(text)
        if m:
            regime[m.group(1)] = bool(_REGIME.match(text))
            continue
        m = re.match(r"@!(P\d) BRA (?:`\()?0x([0-9a-f]+)", text)
        if m and regime.get(m.group(1)):
            target = int(m.group(2), 16)
            skipped.update(a for a, _ in body if addr < a < target)
    return len(body) - len(skipped)


def issue_floor_ms(instr_per_slot: float, elements: int,
                   clock_ghz: float = CLOCK_GHZ,
                   sms: int = H100_SMS) -> float:
    """ms to issue ``instr_per_slot`` instructions for each of ``elements``
    slots, 32 lanes a warp instruction, 4 a cycle an SM."""
    warp_instrs = elements * instr_per_slot / 32
    return 1e3 * warp_instrs / (sms * 4 * clock_ghz * 1e9)


def floor_of(sass: str, function: str, elements: int,
             ilp: int = CM_ILP) -> float:
    """The issue floor (ms) of ``function``'s slot loops in ``sass`` for
    ``elements`` slots, an iteration of each loop running ``ilp`` slots;
    prints each loop and the total."""
    instrs = parse_function(sass, function)
    per_slot = 0.0
    for loop in slot_loops(instrs):
        n = common_path(instrs, loop)
        size = sum(loop[0] <= a <= loop[1] for a, _ in instrs)
        print(f"slot loop {loop[0]:#x}-{loop[1]:#x}: {size} instructions, "
              f"{n} on the common path, {n / ilp:g} a slot")
        per_slot += n / ilp
    floor = issue_floor_ms(per_slot, elements)
    print(f"{function}: {per_slot:g} instructions a slot; issue floor "
          f"{floor:.4f} ms for {elements} slots at {CLOCK_GHZ} GHz "
          f"on {H100_SMS} SMs")
    return floor


def main(argv=None):
    parser = argparse.ArgumentParser(prog="sass_floor")
    parser.add_argument("sass")
    parser.add_argument("function")
    parser.add_argument("--elements", type=int, required=True,
                        help="slots of one call (checks x dc x frames)")
    parser.add_argument("--ilp", type=int, default=CM_ILP,
                        help="slots an iteration of a slot loop runs "
                             f"(default {CM_ILP}, kernel 5's pairs)")
    args = parser.parse_args(argv)
    with open(args.sass) as f:
        return floor_of(f.read(), args.function, args.elements, args.ilp)


if __name__ == "__main__":
    main()
