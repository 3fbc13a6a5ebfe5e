"""CUDA source of ``hopper::Wgmma<N>`` (``ops/csrc/hopper.cuh``): the
``wgmma.mma_async`` m64nNk16 bf16 products of one warpgroup with f32 sums,
both operands from shared memory (``ss``) or A from registers (``rs``).
The header holds this function's output for the widths the kernels use;
the variant tools append it for other widths to a source they build.

    python -m tf_operator_tpu_torch.tools.wgmma_source 64 128 256
"""

from __future__ import annotations

import sys


def wgmma_spec(n: int) -> str:
    """The ``template <> struct Wgmma<n>`` specialization (n / 2 f32 sums a
    thread; n a multiple of 8, at most 256)."""
    r = n // 2
    outs = [", ".join(f'"+f"(d[{j}])' for j in range(i, min(r, i + 7))) for i in range(0, r, 7)]
    regs = [", ".join(f"%{j}" for j in range(i, min(r, i + 8))) for i in range(0, r, 8)]
    reg_lines = "\n".join(f'        "{x}{"," if k < len(regs) - 1 else ""}"'
                          for k, x in enumerate(regs))
    out_lines = ",\n          ".join(outs)
    return f'''template <>
struct Wgmma<{n}> {{
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int accumulate) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{"
{reg_lines}
        "}}, %{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4};\\n}}\\n"
        : {out_lines}
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }}
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b,
                                            int accumulate) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{"
{reg_lines}
        "}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, %{r + 6};\\n}}\\n"
        : {out_lines}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
  }}
}};
'''


def with_widths(source: str, widths) -> str:
    """``source`` (a .cu that includes hopper.cuh) with Wgmma<n> defined for
    each n of ``widths`` right after the include."""
    inc = '#include "hopper.cuh"\n'
    if source.count(inc) != 1:
        raise ValueError("the source must include hopper.cuh once")
    extra = ("namespace hopper {\n" + "\n".join(wgmma_spec(n) for n in widths)
             + "}  // namespace hopper\n")
    return source.replace(inc, inc + extra)


if __name__ == "__main__":
    print("\n".join(wgmma_spec(int(n)) for n in sys.argv[1:]))
