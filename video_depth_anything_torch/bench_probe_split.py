"""Where Kernel A's probe kernels (the spatial ``ilv`` / ``nomask``,
``chunk<k>``, ``sbf16`` / ``sbf16:fast`` / ``ceiling``, and the softmax-chain
probe's seven modes, ``chain:<mode>``) spend their time on the card: each
kernel built in full and with parts taken out, timed at the probe script's
shapes, with its ``ptxas`` lines and the instruction mix of its softmax
chain read from the SASS; Kernel A's forward at D = 192 (``flash192``,
``flash192:fast``), built in full only; and Kernel A's wide forward
(``wide``, ``wide:fast``, ``wide_f32``, ``wide_f32:fast``), split.

    python -m video_depth_anything_torch.bench_probe_split [ROOT ...]
        [--variants ilv nomask chunk2 chunk4 sbf16 sbf16:fast ceiling
                    flash192 flash192:fast chain:gemms ... chain:bf16x
                    wide wide:fast wide_f32 wide_f32:fast]
        [--no-timing] [--timeline]

For example ``python -m video_depth_anything_torch.bench_probe_split
PARENT . --variants wide wide:fast wide_f32 wide_f32:fast`` times an
unpacked parent checkout's wide kernel against this tree's, in turns.

The kernels are built from the ``csrc`` of each checkout ROOT (default:
this tree; for example an unpacked parent commit and this tree, to time
the two in turns on one card), each source rewritten at fixed anchors
behind a ``PROBE_STOP`` / ``PROBE_FLOORF`` macro (built with the macro at
0, the source is the kernel as shipped):

* ``full``: the kernel;
* ``nochain``: the chain removed (p = s, as ``ceiling`` does; exact
  ``sbf16`` keeps a max of the raw scores and p = s - m, which keep its
  max pass's products; l is 1 more than its sum, so that no output
  divides by 0);
* ``noproducts``: the products and the chain removed (loads and stores
  only);
* ``floorf`` (the Hopper design only): ``exp2_poly`` with ``floorf`` and
  ``__float2int_rz``, as the TPU kernel and the ``mma.sync`` kernels take
  the floor and the exponent, in place of the rounding-down add;
* ``noqreload`` (the ``mma.sync`` wide kernel only): its Q panels copied
  at the first key tile only (the later tiles read whatever the ring slot
  holds: a timing, not a result).

The designs are found from the sources (``DESIGNS``): the ``mma.sync``
``sbf16_kernel`` and ``chain_kernel`` of ``csrc/attention_variants.cu`` (in
checkouts that still hold them), the Hopper probes of
``csrc/attention_variants_hopper.cu`` (``ilv``, ``chunk`` and, where the
source has them, ``sbf16_hopper`` and ``chain_hopper``), and
``csrc/flash_attention.cu`` for D = 192, and ``csrc/flash_attention_wide.cu``
(the ``mma.sync`` design of PR 22 or the Hopper one, told apart by
their sources) for the wide variants.  A design is built only where a
variant asked for runs on it.  Each build is timed with CUDA events
(``utils/device.event_ms``) in turns: the builds in order, then in reverse
order, per shape (the chain probe at 512 x 1376 x 1408 with V 128 wide;
the spatial probes at vitl and vits, 32 x 1370; ``flash192`` at
32 x 1370 with 2 heads of 192, q, k and v strided views of one fused qkv
tensor, as the model's projection gives them, and again at B = 30 and 33:
5.0 and 5.5 waves of its CTAs on 132 SMs against 5.33; the wide variants
at the d320 windows' shapes, 32 x 1370 and 32 x 2443 with 4 heads of 320,
strided views of one fused qkv tensor, beside SDPA and the plain version,
and the Hopper design's bf16 full build also with Q streamed and
resident, ``qstream`` and ``qresident``).
The ``full`` and ``floorf`` builds are held against the plain versions
(``spatial_kernel_plain``, ``flash_attention_plain``).  ``--no-timing``
stops after the builds and the SASS; ``--timeline`` also prints the
phases of one CTA of this tree's Hopper ``ilv`` and ``chunk`` kernels,
from ``clock64()`` stamps (``timeline``).

The chain's mix: ``cuobjdump -sass`` of the ``full`` and ``nochain``
builds, opcodes counted in each kernel function; the difference divided
by the number of exponentials in the full build (its ``FRND`` count, or
for the rounding-down add its ``FADD.RM`` count; for the chain probe the
difference of the mode's ``CHAIN_MARKER`` opcode) is the chain's
instructions per score, the chain-free build's counts first scaled to the
full build's number of tensor-core instructions, plus P's bf16 pack (half
an ``F2FP`` a score, in both builds).  The chain bound is the scores
(32 * H * 1408^2 at n = 1370; 512 * 1408^2 for the chain probe) times the
largest of: conversions over 16 a clock, fp32 operations over 128,
integer operations over 64, ``MUFU`` over 16, and all instructions over
128 (the SM's issue rate), on every SM at the card's largest SM clock
(the CUDA C++ Programming Guide's throughputs for compute capability
9.0).  Prints the card's name and power limit, then
one JSON line per kernel function and per timed row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import tempfile
from collections import Counter

N, D, BATCH = 1370, 64, 32
ENCODERS = (("vitl", 16), ("vits", 6))
FLASH_HEADS, FLASH_D = 2, 192  # chip_smoke.py's synthetic D = 192 shape
WAVES = (30, 32, 33)  # batches timed for the D = 192 grid's waves (660, 704, 726 CTAs)
PEAK_BF16 = 989e12
RATE = {"conversion": 16, "fp32": 128, "integer": 64, "mufu": 16}
CLASSES = {
    "conversion": ("F2I", "I2F", "FRND", "F2F", "F2FP", "I2FP", "F2IP"),
    "mufu": ("MUFU",),
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FCHK"),
    "integer": ("IADD3", "IMAD", "IMNMX", "SHF", "LOP3", "ISETP", "SEL", "LEA", "IABS", "IADD",
                "SHL", "SHR", "VIMNMX", "VIADDMNMX", "VIADD"),
}
PACK = "F2FP.BF16.F32.PACK_AB"  # P's bf16 pack: half an instruction a score, in both builds

# The rewrites of each design: (anchor, what replaces it, the kernel kind
# whose code holds the anchor, or None where every source of the design has it).
_STOP1 = "  if (PROBE_STOP >= 1) return;\n"
_STOP2 = "  if (PROBE_STOP >= 2) return;\n"
_QK_ZERO = ("    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;\n#pragma unroll\n  for (int kk = 0; kk < 4;"
            " ++kk)\n#pragma unroll\n    for (int np = 0; np < 4; ++np) {")
_PV_TILE = ("__device__ __forceinline__ void pv_tile(float acc[8][4], const uint32_t p[4][4], "
            "const bf16* sV,\n                                        int lane) {\n")
_MMA_NOPRODUCTS = [  # the mma.sync qk_tile returns once s is zero, pv_tile at once
    (_QK_ZERO, _QK_ZERO.replace("#pragma unroll\n  for (int kk", _STOP2 + "#pragma unroll\n  for (int kk",
                                1), None),
    (_PV_TILE, _PV_TILE + _STOP2, None),
]
_BUILDS = {"full": [], "nochain": ["-DPROBE_STOP=1"], "noproducts": ["-DPROBE_STOP=2"]}
_EXP_ROWS = ("__device__ __forceinline__ void exp_rows(float (&s)[32], float (&l)[2], int valid, "
             "int c2) {\n")
_SBF16_ROWS = ("__device__ __forceinline__ void sbf16_rows(float (&s)[32], float (&l)[2], "
               "const float (&m)[2],\n                                           int valid, int c2) {\n")
# sbf16's chain-free build: p = s; exact keeps p = s - m, and with it the
# max pass (a max a score) and the products that feed it
_SBF16_STOP = ("  if (PROBE_STOP >= 1) {\n    if constexpr (EXACT)\n"
               "      for (int i = 0; i < 32; ++i) s[i] -= m[(i >> 1) & 1];\n    return;\n  }\n")
_KEPT = {"FMNMX": 1.0, "FADD": 1.0}
# Without a chain l is 0, and acc / 0 takes the division's slow path for
# every output: the chain-free builds add 1 to l.
_L_MMA = "  for (int rr = 0; rr < 2; ++rr) l[rr] = CEILING ? float(n_pad) : quad_sum(l[rr]);\n"
_L_HOPPER = "  const float l0 = quad_sum(l_part[0]) - pad, l1 = quad_sum(l_part[1]) - pad;\n"
MMA_SYNC_SBF16 = {  # sbf16 on mma.sync, before its Hopper kernel
    "name": "sbf16-mma", "file": "attention_variants.cu", "marker": "sbf16_kernel",
    "kernels": {"sbf16": "sbf16_kernel"},
    "rewrites": [  # without its chain, exact keeps a max of the raw scores and p = s - m
        (_L_MMA, _L_MMA.replace(");\n", ") + (PROBE_STOP >= 1);\n"), None),
        ("    if constexpr (!CEILING) {\n",
         "    if constexpr (!FAST && !CEILING && PROBE_STOP == 1) {\n"
         "#pragma unroll\n      for (int t = 0; t < 8; ++t)\n#pragma unroll\n"
         "        for (int e = 0; e < 4; ++e) s[t][e] -= m[e >> 1];\n    }\n"
         "    if constexpr (!CEILING && PROBE_STOP < 1) {\n", None),
        ("          m[e >> 1] = fmaxf(m[e >> 1], valid ? bf16_round(s[t][e]) : neg);\n",
         "          m[e >> 1] = fmaxf(m[e >> 1], PROBE_STOP < 1 ? (valid ? bf16_round(s[t][e]) : neg)"
         " : s[t][e]);\n", None),
    ] + _MMA_NOPRODUCTS,
    "builds": _BUILDS,
    "kept": {"sbf16_kernelILb0ELb0E": _KEPT},
}
HOPPER = {  # ilv / chunk, and sbf16 where the source has it
    "name": "hopper", "file": "attention_variants_hopper.cu", "marker": "ilv_hopper",
    "kernels": {"ilv": "ilv_hopper", "chunk": "chunk_hopper", "sbf16": "sbf16_hopper"},
    "rewrites": [
        (_L_HOPPER, _L_HOPPER.replace(" - pad,", " - pad + (PROBE_STOP >= 1),")
         .replace(" - pad;", " - pad + (PROBE_STOP >= 1);"), None),
        (_EXP_ROWS, _EXP_ROWS + _STOP1, None),
        (_SBF16_ROWS, _SBF16_ROWS + _SBF16_STOP, "sbf16"),
        ("__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t dq, uint64_t dk) {\n",
         "__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t dq, uint64_t dk) {\n"
         "  if (PROBE_STOP >= 2) { wgmma_commit(); return; }\n", None),
        ("                                         uint64_t dv, int first) {\n",
         "                                         uint64_t dv, int first) {\n"
         "  if (PROBE_STOP >= 2) { wgmma_commit(); return; }\n", None),
        ("__device__ __forceinline__ float exp2_poly(float x) {\n",
         "__device__ __forceinline__ float exp2_poly(float x) {\n"
         "#if PROBE_FLOORF\n"
         "  {\n"
         "    const float y = fmaxf(x, -200.f), yi = floorf(y), yf = y - yi;\n"
         "    const int e = min(max(__float2int_rz(yi) + 127, 0), 254);\n"
         "    return __int_as_float(e << 23) *\n"
         "           fmaf(yf, fmaf(yf, fmaf(yf, fmaf(yf, 0.0135115307f, 0.051989575f), "
         "0.241508857f), 0.69297426f), 1.00000526f);\n"
         "  }\n"
         "#endif\n", None),
    ],
    "builds": {**_BUILDS, "floorf": ["-DPROBE_FLOORF=1"]},
    "kept": {"sbf16_hopperILb0ELb0E": _KEPT},
}
FLASH = {  # Kernel A's forward; only its D = 192 kernel is timed here
    "name": "flash", "file": "flash_attention.cu", "marker": "vda_flash_attention_fwd",
    "kernels": {"flash192": "vda_flash_attention_fwd"}, "rewrites": [], "builds": {"full": []},
}
# The softmax-chain probe (bench_softmax_chain's seven modes), kind "chain".
# Its chain-free build keeps on purpose what keeps the products alive:
# exact's online max and rescale and p = s - m, bf16x's first pass (the
# max) and p = s - m; the other modes take p = s ("gemms" has no chain).
# "marker" is the SASS opcode of which each mode's chain has one a score
# (MUFU.EX2: exp2f and __expf; sexp's truncation; pexp's floor); "kept" the
# chain's instructions a score that its chain-free build keeps (the max,
# the subtraction, exact's rescale of acc, the mma.sync bf16x's rounding of
# each score in its first pass), added back to the mix.
CHAIN_MODES = ("gemms", "exp", "exact", "sexp", "pexp", "bf16s", "bf16x")
CHAIN_MARKER = {"exp": "MUFU.EX2", "exact": "MUFU.EX2", "sexp": "F2I", "pexp": "FRND",
                "bf16s": "MUFU.EX2", "bf16x": "MUFU.EX2"}
CHAIN_SHAPE = (512, 1376, 1408, 128)  # BH, Nq, Nk, Dv: bench_softmax_chain's
_CHAIN_EXACT_KEPT = {"FMNMX": 1.0, "FADD": 1.0, "FMUL": 1.0}
MMA_SYNC_CHAIN = {  # the chain kernel on mma.sync, before its Hopper kernel
    "name": "chain-mma", "file": "attention_variants.cu", "marker": "chain_kernel",
    "kernels": {"chain": "chain_kernel"},
    "rewrites": [
        ("        s[t][e] = pe;\n",
         "        s[t][e] = PROBE_STOP < 1 ? pe\n"
         "                  : (MODE == EXACT || MODE == BF16X) ? x - m[e >> 1] : x;\n", None),
    ] + _MMA_NOPRODUCTS,
    "builds": _BUILDS,
    "chain_kept": {"exact": _CHAIN_EXACT_KEPT,
                   "bf16x": {"FMNMX": 1.0, "FADD": 1.0, PACK: 1.0, "SHL": 1.0}},
}
_CHAIN_ROWS = ("__device__ __forceinline__ void chain_rows(float (&s)[32], float (&m)[2], "
               "float (&alpha)[2]) {\n")
CHAIN_HOPPER = {  # chain_hopper<MODE>
    "name": "chain-hopper", "file": "attention_variants_hopper.cu", "marker": "chain_hopper",
    "kernels": {"chain": "chain_hopper"},
    "rewrites": [
        (_CHAIN_ROWS, _CHAIN_ROWS +
         "  if (PROBE_STOP >= 1) {\n"
         "    if constexpr (MODE == EXACT) {\n"
         "      for (int r = 0; r < 2; ++r) {\n"
         "        float mx = m[r];\n"
         "        for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[4 * t + 2 * r], "
         "s[4 * t + 2 * r + 1]));\n"
         "        mx = quad_max(mx);\n"
         "        alpha[r] = __expf(m[r] - mx);\n"
         "        m[r] = mx;\n"
         "      }\n"
         "    }\n"
         "    if constexpr (MODE == EXACT || MODE == BF16X)\n"
         "      for (int i = 0; i < 32; ++i) s[i] -= m[(i >> 1) & 1];\n"
         "    return;\n"
         "  }\n", None),
    ] + [r for r in HOPPER["rewrites"] if "PROBE_STOP >= 2" in r[1]],
    "builds": _BUILDS,
    "chain_kept": {"exact": _CHAIN_EXACT_KEPT, "bf16x": {"FMNMX": 1.0, "FADD": 1.0}},
}
WIDE_KINDS = ("wide", "wide_f32")
_WIDE_KERNELS = {"wide": "vda_flash_attention_wide", "wide_f32": "vda_flash_attention_wide_f32"}
_STOP2_BODY = "  if (PROBE_STOP >= 2) return;\n"
WIDE_MMA = {  # PR 22's wide kernel: mma.sync over a cp.async ring, Q copied with every K panel
    "name": "wide-mma", "file": "flash_attention_wide.cu", "marker": "cp_async16",
    "kernels": _WIDE_KERNELS, "exp_marker": "MUFU.EX2",
    "rewrites": [
        ("      if (r == p.panels - 1) {\n",
         "      if (PROBE_STOP >= 1 && r == p.panels - 1) {\n        pf.set(sc);\n"
         "        l_i[0] = l_i[1] = 1.f;\n      } else if (r == p.panels - 1) {\n", None),
        ("      load_tile(buf, qb, p.qs[1], q0, p.n, r * kPanel);\n",
         "      if (!PROBE_NOQ || j == 0) load_tile(buf, qb, p.qs[1], q0, p.n, r * kPanel);\n", None),
    ] + [(head, head + _STOP2_BODY, None) for head in (
        "__device__ __forceinline__ void qk_panel(float (&sc)[32], const bf16* sq, const bf16* sk,\n"
        "                                         int lane) {\n",
        "__device__ __forceinline__ void qk_panel(float (&sc)[32], const float* sq, const float* sk,\n"
        "                                         int lane) {\n",
        "__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<bf16>& pf,\n"
        "                                         const float (&)[32], const bf16* sv, int lane) {\n",
        "__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<float>&,\n"
        "                                         const float (&p)[32], const float* sv, int lane) {\n")],
    "builds": {**_BUILDS, "noqreload": ["-DPROBE_NOQ=1"]},
}
WIDE_HOPPER = {  # the wide kernel on wgmma fed by a TMA ring (a pre-pass splits fp32)
    "name": "wide-hopper", "file": "flash_attention_wide.cu", "marker": "split_vt",
    "kernels": _WIDE_KERNELS, "exp_marker": "MUFU.EX2",
    "rewrites": [
        ("                                             float scale_log2) {\n",
         "                                             float scale_log2) {\n"
         "  if (PROBE_STOP >= 1) {\n    l_i[0] = l_i[1] = 1.f;\n    return;\n  }\n", None),
    ] + [(head, head + _STOP2_BODY, None) for head in (
        "__device__ __forceinline__ void s_panel(float (&sc)[32], const unsigned char* q,\n"
        "                                        const unsigned char* st) {\n",
        "__device__ __forceinline__ void s_panel(float (&sc)[16], const unsigned char* q,\n"
        "                                        const unsigned char* st) {\n",
        "__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<bf16>& pf,\n"
        "                                         const unsigned char* st) {\n",
        "__device__ __forceinline__ void pv_panel(float (&acc)[32], const PFrag<float>& pf,\n"
        "                                         const unsigned char* st) {\n")],
    "builds": _BUILDS,
}
WIDE_SHAPES = (("d320 518x518", 32, 1370, 4), ("d320 518x924", 32, 2443, 4))  # label, B*T, N, H
WIDE_D = 320
DESIGNS = (MMA_SYNC_SBF16, MMA_SYNC_CHAIN, HOPPER, CHAIN_HOPPER, FLASH, WIDE_MMA, WIDE_HOPPER)


def kind_of(variant: str) -> str:
    """The kernel kind a variant runs on: ``ilv``, ``chunk``, ``sbf16``,
    ``flash192``, ``chain`` (variants ``chain:<mode>``), ``wide`` or
    ``wide_f32`` (each also ``:fast``)."""
    if variant in ("flash192", "flash192:fast"):
        return "flash192"
    if variant in (*WIDE_KINDS, "wide:fast", "wide_f32:fast"):
        return variant.split(":")[0]
    if variant.startswith("chain:"):
        if variant[6:] not in CHAIN_MODES:
            raise ValueError(variant)
        return "chain"
    from video_depth_anything_torch.ops.attention_variants import parse_variant

    return parse_variant(variant, N)[0]


def rewrite(text: str, design: dict, kinds) -> str:
    """The source with the design's rewrites of the kernels in ``kinds``."""
    for anchor, new, kind in design["rewrites"]:
        if kind is not None and kind not in kinds:
            continue
        if text.count(anchor) != 1:
            raise SystemExit(f"bench_probe_split: anchor not found once in {design['file']}: "
                             f"{anchor[:60]!r}")
        text = text.replace(anchor, new)
    return "#ifndef PROBE_STOP\n#define PROBE_STOP 0\n#endif\n#ifndef PROBE_FLOORF\n" \
           "#define PROBE_FLOORF 0\n#endif\n#ifndef PROBE_NOQ\n#define PROBE_NOQ 0\n#endif\n" + text


def designs_of(root: str) -> list:
    """``[(design, csrc, kinds)]``: the designs whose sources the checkout
    holds, each with the kernel kinds its source has."""
    csrc = os.path.join(root, "video_depth_anything_torch", "csrc")
    out = []
    for design in DESIGNS:
        path = os.path.join(csrc, design["file"])
        text = open(path).read() if os.path.exists(path) else ""
        if design["marker"] in text:
            kinds = tuple(k for k, fn in design["kernels"].items() if fn in text)
            out.append((design, csrc, kinds))
    if not out:
        raise SystemExit(f"bench_probe_split: no kernels of a known design under {csrc}")
    return out


def start_build(tag: str, csrc: str, design: dict, kinds, flags: list, out_dir: str):
    """Start compiling the rewritten source with ``flags``: ``(process,
    library path)``."""
    from video_depth_anything_torch.ops import cuda_build

    d = os.path.join(out_dir, tag)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), d)
    cu, so = os.path.join(d, "probe.cu"), os.path.join(d, "libprobe.so")
    with open(os.path.join(csrc, design["file"])) as f:
        text = rewrite(f.read(), design, kinds)
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish_build(tag: str, proc) -> list:
    """Wait for a build; its ``ptxas`` lines (registers, spills, wgmma)."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"bench_probe_split: nvcc failed for {tag}:\n{out}")
    return [ln.strip() for ln in out.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln or "wgmma" in ln]


def entry(lib, kind: str):
    """The C entry point of ``kind`` in a built library, with its types."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kind == "flash192":
        fn = lib.vda_flash_attention_fwd
        fn.argtypes = [vp] * 4 + [i] * 4 + [ctypes.c_longlong] * 12 + [f, i, vp, vp]
    elif kind in WIDE_KINDS:  # PR 22's: ..., scale, fast, stream; the Hopper design's takes
        # bf16's q_resident or fp32's scratch before the stream
        fn = getattr(lib, _WIDE_KERNELS[kind])
        hopper = hasattr(lib, "vda_flash_attention_wide_f32_scratch")
        fn.argtypes = ([vp] * 4 + [i] * 4 + [ctypes.c_longlong] * 12 + [f, i]
                       + ([vp if kind == "wide_f32" else i] if hopper else []) + [vp])
    elif kind == "chain":  # q, k, v, o, bh, nq, nk, dv, mode, stream
        fn = lib.vda_chain
        fn.argtypes = [vp] * 4 + [i] * 5 + [vp]
    else:  # q, k, v, o, B, n, heads, qscale, two flags, stream
        fn = getattr(lib, f"vda_{kind}")
        fn.argtypes = [vp] * 4 + [i] * 3 + [f, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def sass_opcodes(so: str) -> dict:
    """``{function name: Counter of opcodes}`` from ``cuobjdump -sass``."""
    from video_depth_anything_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:  # the anonymous namespace's hash differs from build to build
            cur = funcs.setdefault(re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", m.group(1)),
                                   Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return funcs


def chain_mix(full: Counter, nochain: Counter, kept=None, marker=None) -> dict:
    """The chain's instructions per score by opcode and by class: the full
    build's counts less the chain-free build's, the latter scaled to the
    same number of tensor-core instructions (HMMA or HGMMA), so that a
    loop unrolled another number of times in one build cancels; plus
    ``kept``, the chain's instructions a score that the chain-free build
    keeps on purpose (exact ``sbf16``'s max and subtraction, which keep its
    max pass's products alive).  The scores are the full build's
    exponentials (``FRND``, else the rounding-down ``FADD.RM``), or with
    ``marker`` the difference of that opcode's counts (one a score)."""
    def products(c):
        return sum(v for k, v in c.items() if k.split(".")[0] in ("HMMA", "HGMMA"))

    if products(nochain) == 0:
        return {"error": "no product found in the SASS"}
    r = products(full) / products(nochain)
    if marker is not None:
        scores = sum(v for k, v in full.items() if k.startswith(marker)) - r * sum(
            v for k, v in nochain.items() if k.startswith(marker))
    else:
        scores = sum(v for k, v in full.items() if k.split(".")[0] == "FRND")
        if scores == 0:
            scores = sum(v for k, v in full.items() if k.startswith("FADD") and ".RM" in k)
    if scores <= 0:
        return {"error": "no exponential found in the SASS"}
    diff = {k: (full.get(k, 0) - r * nochain.get(k, 0)) / scores
            for k in set(full) | set(nochain)}
    diff = {k: v for k, v in diff.items() if abs(v) >= 0.01}
    for k, v in {PACK: 0.5, **(kept or {})}.items():
        diff[k] = diff.get(k, 0.0) + v
    by_class = Counter()
    for k, v in diff.items():
        base = k.split(".")[0]
        cls = next((c for c, ops in CLASSES.items() if base in ops), "other")
        by_class[cls] += v
    by_class["total"] = sum(diff.values())
    return {"exponentials_in_sass": scores, "products_ratio": round(r, 3),
            "per_score": {k: round(v, 3) for k, v in sorted(diff.items())},
            "per_score_by_class": {k: round(v, 3) for k, v in by_class.items()}}


def chain_bound_ms(by_class: dict, scores: float, sms: int, clock_hz: float) -> float:
    cycles = max([by_class.get(c, 0.0) / r for c, r in RATE.items()]
                 + [by_class.get("total", 0.0) / 128])
    return scores * cycles / (sms * clock_hz) * 1e3


# --timeline: clock64() stamps of one CTA's warpgroups, written by thread 0
# of each, at the phases of every key tile (ilv) or step (chunk)
_TIMELINE_HEAD = """
__device__ long long g_stamps[2][4096];
#define STAMP(idx) do { if ((threadIdx.x & 127) == 0 && blockIdx.x == STAMP_X && \\
    blockIdx.y == 3 && blockIdx.z == 16) g_stamps[cw][(idx)] = clock64(); } while (0)
"""
TIMELINE = [  # (anchor, the anchor with stamps)
    ("namespace {\n\nconstexpr int kQRows", _TIMELINE_HEAD + "namespace {\n\nconstexpr int kQRows"),
    ("    mbar_wait(&sm.full[s], (j / kIlvStages) & 1);\n",
     "    STAMP(j * 8);\n    mbar_wait(&sm.full[s], (j / kIlvStages) & 1);\n    STAMP(j * 8 + 1);\n"),
    ("    fence_regs(s0);\n    exp_rows<MASK>(s0, l0, valid, c2);\n",
     "    fence_regs(s0);\n    STAMP(j * 8 + 2);\n    exp_rows<MASK>(s0, l0, valid, c2);\n"),
    ("    exp_rows<MASK>(s0, l0, valid, c2);\n    pack_p(p0, s0);\n",
     "    exp_rows<MASK>(s0, l0, valid, c2);\n    pack_p(p0, s0);\n    STAMP(j * 8 + 3);\n"),
    ("    fence_regs(s1);\n    exp_rows<MASK>(s1, l1, valid, c2);\n",
     "    fence_regs(s1);\n    STAMP(j * 8 + 4);\n    exp_rows<MASK>(s1, l1, valid, c2);\n"),
    ("    exp_rows<MASK>(s1, l1, valid, c2);\n    pack_p(p1, s1);\n",
     "    exp_rows<MASK>(s1, l1, valid, c2);\n    pack_p(p1, s1);\n    STAMP(j * 8 + 5);\n"),
    ("    mbar_wait(&sm.full[i % kChunkStages], (i / kChunkStages) & 1);\n",
     "    STAMP(i * 8);\n    mbar_wait(&sm.full[i % kChunkStages], (i / kChunkStages) & 1);\n"
     "    STAMP(i * 8 + 1);\n"),
    ("    wgmma_wait<WS>();\n    fence_regs(S[PAR ^ 1]);\n",
     "    wgmma_wait<WS>();\n    fence_regs(S[PAR ^ 1]);\n    STAMP(i * 8 + 2);\n"),
    ("    if constexpr (WP >= 0) {\n      wgmma_wait<WP>();\n",
     "    STAMP(i * 8 + 3);\n    if constexpr (WP >= 0) {\n      wgmma_wait<WP>();\n      STAMP(i * 8 + 4);\n"),
]
# phases between stamps 0..5 (ilv) or 0..4 (chunk), then to the next step's stamp 0
PHASES = {"ilv": ("wait_full", "s0_wait", "chain0", "s1_wait", "chain1", "pv1_to_next"),
          "chunk": ("wait_full", "s_issue_wait", "chain", "pv_wait", "pack_pv_to_next")}


def timeline(csrc: str, out_dir: str, variants) -> None:
    """Build the Hopper kernels with clock64() stamps and print, for one
    CTA of each variant at vitl, each warpgroup's median cycles per phase
    over its middle steps (a CTA deep in the grid: x = 5 for ilv, 1 for
    chunk; pair 3, batch 16)."""
    import statistics

    import torch

    from video_depth_anything_torch.ops import attention_variants as av
    from video_depth_anything_torch.ops import cuda_build

    with open(os.path.join(csrc, HOPPER["file"])) as f:
        text = f.read()
    for anchor, new in TIMELINE:
        if text.count(anchor) != 1:
            raise SystemExit(f"bench_probe_split: timeline anchor not found once: {anchor[:60]!r}")
        text = text.replace(anchor, new)
    text += ('\nextern "C" int vda_stamps(void* out) {\n'
             '  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n')
    libs = {}
    for x in (5, 1):
        d = os.path.join(out_dir, f"timeline{x}")
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(csrc):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, f), d)
        with open(os.path.join(d, "probe.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "libprobe.so")
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DSTAMP_X={x}", "-o",
                               so, os.path.join(d, "probe.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"bench_probe_split: timeline build failed:\n{proc.stdout}{proc.stderr}")
        libs[x] = ctypes.CDLL(so)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    heads = 16
    q, k, v = ((torch.randn(BATCH, N, heads * D, generator=gen, device=dev) * std)
               .to(torch.bfloat16) for std in (0.5, 0.5, 1.0))
    for variant in variants:
        kind, arg = av.parse_variant(variant, N)
        lib = libs[5 if kind == "ilv" else 1]
        fn = getattr(lib, f"vda_{kind}")
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [i] * 3 + [ctypes.c_float, i, i, vp]
        fn.restype = ctypes.c_int
        for _ in range(3):
            out = torch.empty_like(q)
            cuda_build.check(fn(*(cuda_build.ptr(t) for t in (q, k, v, out)), BATCH, N, heads,
                                float(D**-0.5 * av.LOG2E), int(arg), 0, cuda_build.stream_of(q)),
                             "timeline")
        torch.cuda.synchronize()
        buf = torch.zeros(2, 4096, dtype=torch.int64)
        cuda_build.check(lib.vda_stamps(ctypes.c_void_p(buf.data_ptr())), "stamps")
        n_pad = -(-N // 128) * 128
        # the CTA's key tiles (ilv) or steps (chunk: CTA x = 1 has min(nc, its chunks) chunks)
        steps = (n_pad // 64 if kind == "ilv"
                 else 2 * min(arg, -(-(N - arg * 128) // 128)) * (n_pad // 64))
        names = PHASES[kind]
        for wg in range(2):
            b = buf[wg].tolist()
            rows = {name: [] for name in names}
            for j in range(2, steps - 3):
                marks = [b[j * 8 + c] for c in range(len(names))] + [b[(j + 1) * 8]]
                for c, name in enumerate(names):
                    rows[name].append(marks[c + 1] - marks[c])
            per_step = statistics.median(b[(j + 1) * 8] - b[j * 8] for j in range(2, steps - 3))
            print(json.dumps({"timeline": variant, "enc": "vitl", "warpgroup": wg,
                              "cycles_per_step": per_step,
                              "median_cycles": {n_: statistics.median(r) for n_, r in
                                                rows.items()}}), flush=True)


def time_wide(variants, builds, time_rows, gen, dev) -> None:
    """The wide variants at WIDE_SHAPES: each build in turns, beside SDPA,
    the plain version and the dense bound (3xTF32 in fp32); the Hopper
    design's bf16 full build also with Q streamed and resident
    (``:qstream``, ``:qresident``)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import cuda_build
    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.utils.device import event_ms

    d, scale = WIDE_D, WIDE_D**-0.5
    for label, bsz, n, h in WIDE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            kind = "wide_f32" if dtype == torch.float32 else "wide"
            mine = [v_ for v_ in variants if kind_of(v_) == kind]
            if not mine:
                continue
            qkv = torch.randn(bsz, n, 3 * h * d, generator=gen, device=dev)
            qkv[..., :2 * h * d] *= 0.5
            q, k, v = (t.view(bsz, n, h, d) for t in qkv.to(dtype).split(h * d, dim=-1))
            del qkv
            strides = fa._check_inputs("wide", q, k, v, takes=fa.wide, dtypes=(dtype,))
            scratch = (torch.empty(fa.wide_f32_scratch_elems(bsz, n, h, d), device=dev)
                       if dtype == torch.float32 else None)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            dense = 4.0 * bsz * n * n * h * d
            peak = PEAK_BF16 if dtype == torch.bfloat16 else 495e12 / 3
            extra = {"sdpa_ms": round(event_ms(lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, scale=scale), iters=5, warmup=1), 4),
                     "tensor_bound_ms": round(dense / peak * 1e3, 4)}
            for variant in mine:
                fast = variant.endswith(":fast")
                plain_ms = round(event_ms(lambda: fa.flash_attention_plain(
                    q, k, v, scale, fast=fast), iters=2, warmup=1), 4)

                def run(tag, fast=fast, q_resident=-1):
                    out = torch.empty_like(q)
                    tail = []
                    if ":wide-hopper:" in tag:
                        tail = [cuda_build.ptr(scratch) if scratch is not None else q_resident]
                    err = builds[tag][0][kind](*(cuda_build.ptr(t) for t in (q, k, v, out)), bsz, n,
                                               h, d, *strides, n * h * d, h * d, d, float(scale),
                                               int(fast), *tail, cuda_build.stream_of(q))
                    cuda_build.check(err, tag)
                    return out

                want = fa.flash_attention_plain(q, k, v, scale, fast=fast).float()
                time_rows(label, variant, kind, run, want, {**extra, "plain_ms": plain_ms})
                # bf16's full build with Q forced streamed and resident
                others = ({"qstream": dict(q_resident=0), "qresident": dict(q_resident=1)}
                          if kind == "wide" else {})
                for tag in [t_ for t_ in builds if t_.endswith(":wide-hopper:full")]:
                    for name, kw in others.items():
                        o_ms = event_ms(lambda tag=tag, kw=kw: run(tag, **kw))
                        got = run(tag, **kw).float()
                        print(json.dumps({"enc": label, "variant": variant,
                                          "build": f"{tag}:{name}", "ms": round(o_ms, 4),
                                          "rel_err": float((got - want).abs().max()
                                                           / want.abs().max()), **extra}),
                              flush=True)
                del want
            del q, k, v, qt, kt, vt, scratch
            torch.cuda.empty_cache()


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts whose kernels to build (default: this one)")
    ap.add_argument("--variants", nargs="+",
                    default=["ilv", "nomask", "chunk2", "chunk4", "sbf16", "sbf16:fast", "ceiling",
                             "flash192", "flash192:fast"] + [f"chain:{m}" for m in CHAIN_MODES])
    ap.add_argument("--no-timing", action="store_true",
                    help="builds, ptxas lines and the chain's mix only")
    ap.add_argument("--timeline", action="store_true",
                    help="also the phases of one CTA of this tree's Hopper kernels, by clock64()")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import attention_variants as av
    from video_depth_anything_torch.ops import cuda_build
    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.utils.device import card_line, event_ms

    if not torch.cuda.is_available():
        print("bench_probe_split: no CUDA device", flush=True)
        return 3
    print(card_line(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [os.path.abspath(r) for r in args.roots or [here]]
    trees = [(os.path.basename(r) or r, r) for r in roots]
    wanted = {kind_of(v) for v in args.variants}
    out_dir = tempfile.mkdtemp(prefix="probe_split_")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    # the designs each tree builds: those that run a variant asked for
    plans = [(tree, design, csrc, kinds) for tree, root in trees
             for design, csrc, kinds in designs_of(root) if wanted & set(kinds)]
    builds, started = {}, {}  # tag -> (kind -> entry point, kinds); tag -> (process, library)
    for tree, design, csrc, kinds in plans:
        for name, flags in design["builds"].items():
            tag = f"{tree}:{design['name']}:{name}"
            started[tag] = start_build(tag.replace(":", "_"), csrc, design, kinds, flags, out_dir)
    for tree, design, csrc, kinds in plans:
        sass = {}
        for name in design["builds"]:
            tag = f"{tree}:{design['name']}:{name}"
            proc, so = started[tag]
            for ln in finish_build(tag, proc):
                print(f"[ptxas] {tag}: {ln}", flush=True)
            if name in ("full", "nochain"):
                sass[name] = sass_opcodes(so)
            lib = ctypes.CDLL(so)
            builds[tag] = ({kind: entry(lib, kind) for kind in kinds}, kinds)
        if "nochain" not in sass:
            continue
        for kind in kinds:
            for func, counts in sass["full"].items():
                if design["kernels"][kind] not in func:
                    continue
                nochain = sass["nochain"].get(func, Counter())
                row = {"tree": tree, "kernel": kind, "function": func}
                if kind == "chain":  # the mode is the template's first argument
                    mode = CHAIN_MODES[int(re.search(r"ILi(\d)E", func).group(1))]
                    row["mode"] = mode
                    if mode == "gemms":  # no chain
                        print(json.dumps(row), flush=True)
                        continue
                    mix = chain_mix(counts, nochain, design["chain_kept"].get(mode),
                                    CHAIN_MARKER[mode])
                else:
                    kept = next((v for k, v in design.get("kept", {}).items() if k in func), None)
                    mix = chain_mix(counts, nochain, kept, design.get("exp_marker"))
                row.update(mix, counts_full=dict(counts), counts_nochain=dict(nochain))
                if "per_score_by_class" in mix and kind == "chain":
                    bh, _, nk, _ = CHAIN_SHAPE  # both designs compute 1408 query rows
                    row["chain_bound_ms"] = round(chain_bound_ms(
                        mix["per_score_by_class"], bh * 1408.0 * nk, sms, clock), 4)
                elif "per_score_by_class" in mix and kind not in WIDE_KINDS:
                    row["chain_bound_ms"] = {
                        enc: round(chain_bound_ms(mix["per_score_by_class"],
                                                  BATCH * h * 1408.0 * 1408.0, sms, clock), 4)
                        for enc, h in ENCODERS}
                print(json.dumps(row), flush=True)
    print(json.dumps({"sms": sms, "max_sm_clock_mhz": clock / 1e6}), flush=True)
    if args.timeline:
        timeline(os.path.join(here, "video_depth_anything_torch", "csrc"), out_dir,
                 [v for v in args.variants if kind_of(v) in ("ilv", "chunk")])
    if args.no_timing:
        shutil.rmtree(out_dir, ignore_errors=True)
        return 0

    def time_rows(label, variant, kind, run, want, extra):
        """Each build of ``kind`` timed in turns (in order, then reversed)."""
        tags = [tag for tag, (_, kinds) in builds.items() if kind in kinds]
        times = {tag: [] for tag in tags}
        for order in (tags, tags[::-1]):
            for tag in order:
                times[tag].append(event_ms(lambda tag=tag: run(tag)))
        for tag in tags:
            row = {"enc": label, "variant": variant, "build": tag,
                   "ms": round(sum(times[tag]) / 2, 4),
                   "ms_turns": [round(t, 4) for t in times[tag]], **extra}
            if tag.endswith(("full", "floorf")):
                got = run(tag).float()
                row["rel_err"] = float((got - want).abs().max() / want.abs().max())
            print(json.dumps(row), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    chain = [v_ for v_ in args.variants if kind_of(v_) == "chain"]
    if chain:  # bench_softmax_chain's inputs: q, k ~ N(0, 0.35^2), v ~ N(0, 1)
        bh, nq, nk, dv = CHAIN_SHAPE
        q, k, v = ((torch.randn(*shape, generator=gen, device=dev) * std).to(torch.bfloat16)
                   for shape, std in (((bh, nq, D), 0.35), ((bh, nk, D), 0.35),
                                      ((bh, nk, dv), 1.0)))
        extra = {"tensor_bound_ms": round(4.0 * bh * nq * nk * D / PEAK_BF16 * 1e3, 4)}
        for variant in chain:
            mode = variant[6:]

            def run(tag, mode=mode):
                out = torch.empty_like(q)
                err = builds[tag][0]["chain"](*(cuda_build.ptr(t) for t in (q, k, v, out)), bh,
                                              nq, nk, dv, CHAIN_MODES.index(mode),
                                              cuda_build.stream_of(q))
                cuda_build.check(err, tag)
                return out

            want = av.softmax_chain_plain(mode, q, k, v).float()
            time_rows("chain 512x1376x1408", variant, "chain", run, want, extra)
            del want
        del q, k, v
        torch.cuda.empty_cache()
    scale = D**-0.5
    spatial = [v for v in args.variants if kind_of(v) not in ("flash192", "chain", *WIDE_KINDS)]
    for enc, heads in ENCODERS if spatial else ():
        q, k, v = ((torch.randn(BATCH, N, heads * D, generator=gen, device=dev) * std)
                   .to(torch.bfloat16) for std in (0.5, 0.5, 1.0))
        qt, kt, vt = (t.view(BATCH, N, heads, D).transpose(1, 2) for t in (q, k, v))
        extra = {"sdpa_ms": round(event_ms(lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, scale=scale)), 4),
                 "tensor_bound_ms": round(4.0 * BATCH * heads * N * N * D / PEAK_BF16 * 1e3, 4)}
        for variant in spatial:
            kind, arg = av.parse_variant(variant, N)
            flags = (int(arg[0]), int(arg[1])) if kind == "sbf16" else (int(arg), 0)

            def run(tag, kind=kind, flags=flags):
                out = torch.empty_like(q)
                err = builds[tag][0][kind](*(cuda_build.ptr(t) for t in (q, k, v, out)), BATCH, N,
                                           heads, float(scale * av.LOG2E), *flags,
                                           cuda_build.stream_of(q))
                cuda_build.check(err, tag)
                return out

            want = av.spatial_kernel_plain(kind, arg, q, k, v, scale, heads).float()
            time_rows(enc, variant, kind, run, want, extra)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    wide = [v_ for v_ in args.variants if kind_of(v_) in WIDE_KINDS]
    if wide:
        time_wide(wide, builds, time_rows, gen, dev)
    flash = [v_ for v_ in args.variants if kind_of(v_) == "flash192"]
    if not flash:
        shutil.rmtree(out_dir, ignore_errors=True)
        return 0
    h, d = FLASH_HEADS, FLASH_D
    qkv = torch.randn(WAVES[-1], N, 3 * h * d, generator=gen, device=dev)
    qkv[..., :2 * h * d] *= 0.5
    qkv_all = [t.view(WAVES[-1], N, h, d) for t in qkv.to(torch.bfloat16).split(h * d, dim=-1)]
    q, k, v = (t[:BATCH] for t in qkv_all)
    strides = fa._check_inputs("flash192", q, k, v, takes=lambda x: x == d)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    extra = {"sdpa_ms": round(event_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, scale=d**-0.5)), 4),
             "tensor_bound_ms": round(4.0 * BATCH * h * N * N * d / PEAK_BF16 * 1e3, 4)}
    def run_flash(tag, fast, bsz=BATCH):
        qb, kb, vb = (t[:bsz] for t in qkv_all)
        out = torch.empty(bsz, N, h, d, dtype=q.dtype, device=dev)
        err = builds[tag][0]["flash192"](*(cuda_build.ptr(t) for t in (qb, kb, vb, out)), bsz, N,
                                         h, d, *strides, N * h * d, h * d, d, float(d**-0.5),
                                         int(fast), None, cuda_build.stream_of(q))
        cuda_build.check(err, tag)
        return out

    for variant in flash:
        fast = variant.endswith(":fast")
        want = fa.flash_attention_plain(q, k, v, d**-0.5, fast=fast).float()
        time_rows(f"synthetic H={h} D={d}", variant, "flash192",
                  lambda tag, fast=fast: run_flash(tag, fast), want, extra)
        # the grid's waves: 128-query CTAs, one an SM at most
        for tag in [t_ for t_, (_, kinds) in builds.items() if "flash192" in kinds]:
            ctas = -(-N // 128) * h
            ms = {bsz: round(event_ms(lambda bsz=bsz: run_flash(tag, fast, bsz)), 4) for bsz in WAVES}
            print(json.dumps({"variant": variant, "build": tag, "waves": {
                bsz: {"ctas": ctas * bsz, "waves": round(ctas * bsz / sms, 3), "ms": t_ms}
                for bsz, t_ms in ms.items()}}), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
