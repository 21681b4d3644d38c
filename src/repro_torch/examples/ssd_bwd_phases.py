"""Time the phases of the SSD backward kernel on the card.

  python3 src/repro_torch/examples/ssd_bwd_phases.py [--src TREE/src] [--label NAME]

The card's machine has no ``ncu``, so this copies a tree's
``csrc/ssd_chunk_bwd.cu`` into a temporary directory, puts a ``clock64()``
stamp at each phase boundary (thread 0 of every CTA adds the cycles since
the previous stamp to that phase's slot in shared memory, and writes the
slots to global memory when the kernel ends), builds the copy alone with
the library's ``nvcc`` flags and calls its ``ssd_chunk_bwd_f32`` at
``kernel_times.SSD_BWD_SHAPES``.  The committed source is never changed.

Where the stamps go: the source marks its phases with ``// phase: NAME``
comment lines, and each gets a stamp.  A stamp counts the time since the
stamp before it, so a phase that ends at a block-wide barrier includes the
wait there; a phase named "(warp 0)" ends at no barrier and is warp 0's
own time.  Each shape's cycles are the mean of ``REPS`` calls.

Per shape it prints each phase's share of the CTAs' summed cycles, its
mean cycles per CTA, and the main and reduce kernels' device ms of the
unpatched wrapper (``torch.profiler``), with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SLOTS = 16          # phases a CTA can record
MAX_CTAS = 4096
REPS = 20          # calls a shape's cycles are averaged over

PRELUDE = f"""
__device__ long long g_phase_clk[{MAX_CTAS} * {SLOTS}];
#define PHASE_STAMP(k) do {{ if (threadIdx.x == 0) {{ const long long _t = clock64(); \\
  phase_acc_[k] += _t - phase_last_; phase_last_ = _t; }} }} while (0)
"""
# the kernel's own lines: the slots in shared memory, and their flush at its end
OPEN = (f"  __shared__ long long phase_acc_[{SLOTS}];\n"
        f"  if (threadIdx.x == 0) for (int k_ = 0; k_ < {SLOTS}; ++k_) phase_acc_[k_] = 0;\n"
        "  long long phase_last_ = clock64();")
FLUSH = (f"  if (threadIdx.x == 0) for (int k_ = 0; k_ < {SLOTS}; ++k_) "
         f"g_phase_clk[blockIdx.x * {SLOTS} + k_] += phase_acc_[k_];")

EPILOGUE = f"""
extern "C" int ssd_bwd_phase_zero() {{
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_phase_clk);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(long long) * {MAX_CTAS} * {SLOTS});
  return static_cast<int>(e);
}}
extern "C" int ssd_bwd_phase_read(void* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_clk,
                                               sizeof(long long) * {MAX_CTAS} * {SLOTS}));
}}
"""


def instrument(text: str) -> tuple[str, list[str]]:
    """The source with stamps at its phase boundaries, and the phase names
    by slot."""
    lines = text.splitlines()
    names: list[str] = []

    def slot(name: str) -> int:
        if name not in names:
            names.append(name)
        return names.index(name)

    marked = [i for i, ln in enumerate(lines) if ln.strip().startswith("// phase:")]
    if not marked:
        raise ValueError("the source has no `// phase:` markers")
    for i in marked:
        name = lines[i].strip()[len("// phase:"):].strip()
        lines[i] = lines[i].replace(lines[i].strip(), f"PHASE_STAMP({slot(name)});")
    inserts: dict[int, list[str]] = {}
    start = next(i for i, ln in enumerate(lines) if "extern __shared__" in ln and "smem" in ln)
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    inserts.setdefault(end, []).append(FLUSH)
    out = []
    for i, ln in enumerate(lines):
        out.extend(inserts.get(i, []))
        out.append(ln)
        if i == start:
            out.append(OPEN)
    # the slots' static shared memory comes off the dynamic limit
    body = "\n".join(out).replace("constexpr size_t kMaxSmem = 232448;",
                                   f"constexpr size_t kMaxSmem = {232448 - 8 * SLOTS};")
    include_end = max(m.end() for m in re.finditer(r"#include [^\n]+\n", body))
    body = body[:include_end] + PRELUDE + body[include_end:] + EPILOGUE
    if len(names) > SLOTS:
        raise ValueError(f"{len(names)} phases, at most {SLOTS}")
    return body, names


def build_copy(src_root: Path, tmp: Path) -> tuple[ctypes.CDLL, list[str]]:
    from repro_torch.kernels import build
    csrc = src_root / "repro_torch" / "kernels" / "csrc"
    text, names = instrument((csrc / "ssd_chunk_bwd.cu").read_text())
    cu = tmp / "ssd_chunk_bwd_phases.cu"
    cu.write_text(text)
    lib = tmp / "libssd_bwd_phases.so"
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    proc = subprocess.run([build.nvcc_path(), *flags, "-shared", "-I", str(csrc), str(cu),
                           "-o", str(lib)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    cdll.ssd_chunk_bwd_f32.argtypes = [*(P,) * 15, I64, *(I,) * 6, P]
    cdll.ssd_chunk_bwd_plan.argtypes = [I] * 6 + [ctypes.POINTER(I)] * 3 \
        + [ctypes.POINTER(I64)] * 2 + [ctypes.POINTER(I)] * 2 + [ctypes.POINTER(I64)]
    cdll.ssd_bwd_phase_read.argtypes = [P]
    return cdll, names


def run_copy(cdll, args, b, nc, L, h, p, n) -> int:
    """One call of the instrumented entry on ``args`` (outputs dropped);
    returns its CTAs."""
    x, dt, A, B, C, dy, dS, dg = args
    i = [ctypes.c_int() for _ in range(3)]
    j = [ctypes.c_int64() for _ in range(2)]
    k = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()]
    code = cdll.ssd_chunk_bwd_plan(b, nc, L, h, p, n, *map(ctypes.byref, i + j + k))
    if code:
        raise RuntimeError(f"plan: CUDA error {code}")
    part = torch.empty(j[1].value, dtype=torch.float32, device=x.device)
    dapart = torch.empty(8 * b * nc * h, dtype=torch.float32, device=x.device)
    outs = [torch.empty_like(t) for t in (x, dt, A, B, C)]
    code = cdll.ssd_chunk_bwd_f32(
        *(t.data_ptr() for t in (x, dt, A, B, C, dy, dS, dg, *outs, part, dapart)),
        j[1].value, b, nc, L, h, p, n, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"ssd_chunk_bwd_f32: CUDA error {code}")
    return i[2].value


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: no CUDA device available", file=sys.stderr)
        return 2
    src_root = Path(args.src).resolve()
    sys.path.insert(0, str(src_root))
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    from kernel_times import SSD_BWD_SHAPES, kernel_breakdown, ssd_bwd_inputs, time_ms
    from repro_torch.kernels import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{args.label}] card: {card.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        cdll, names = build_copy(src_root, Path(tmp))
        for b, nc, L, h, p, n in SSD_BWD_SHAPES:
            inputs = ssd_bwd_inputs(b, nc, L, h, p, n, gen, dev)
            ms = time_ms(lambda: ops.ssd_chunk_bwd(*inputs))
            kernels = kernel_breakdown(lambda: ops.ssd_chunk_bwd(*inputs), ms)
            run_copy(cdll, inputs, b, nc, L, h, p, n)
            torch.cuda.synchronize()
            cdll.ssd_bwd_phase_zero()
            for _ in range(REPS):
                ctas = run_copy(cdll, inputs, b, nc, L, h, p, n)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (MAX_CTAS * SLOTS))()
            cdll.ssd_bwd_phase_read(ctypes.cast(buf, ctypes.c_void_p))
            clk = torch.tensor(list(buf), dtype=torch.float64).view(MAX_CTAS, SLOTS)
            clk = clk[:ctas, :len(names)] / REPS
            per_cta = clk.sum(1)
            total = float(clk.sum())
            shares = ", ".join(f"{name} {100 * float(clk[:, k].sum()) / total:.1f} % "
                               f"({float(clk[:, k].mean()):.0f} cyc)"
                               for k, name in enumerate(names))
            main_ms = sum(v for k, v in kernels.items() if "reduce" not in k)
            red_ms = sum(v for k, v in kernels.items() if "reduce" in k)
            print(f"[{args.label}] ssd_chunk_bwd b={b} nc={nc} L={L} h={h} p={p} n={n}: "
                  f"{ctas} CTAs, cycles a CTA mean {float(per_cta.mean()):.0f} max "
                  f"{float(per_cta.max()):.0f}; device ms main {main_ms:.4f} reduce "
                  f"{red_ms:.4f} (event {ms:.4f}); phases {shares}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
