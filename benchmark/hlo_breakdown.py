"""Per-instruction byte accounting of the compiled AB2 step.

`cost_analysis()` gives one aggregate "bytes accessed" number; this dumps
the optimized HLO as compiled for the card and
ranks entry-computation instructions by bytes touched (result bytes +
operand bytes looked up from a symbol table), localizing bandwidth leaks:
stray copies, un-fused pads, non-in-place dynamic-update-slices. Textual
and approximate — fusion internals are invisible, which is the right
granularity for HBM traffic (a fusion reads operands / writes results
once).
"""
import re, sys, collections
import bench_common
DEVICE = bench_common.setup()
import jax, jax.numpy as jnp
from clima_oceananigans_jl_tpu import PERIODIC, BOUNDED, RectilinearGrid, WENO5
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
top = int(sys.argv[2]) if len(sys.argv) > 2 else 40

grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                       topology=(PERIODIC, PERIODIC, BOUNDED), dtype=jnp.float32)
model = NonhydrostaticModel(grid, advection=WENO5(), buoyancy=BuoyancyTracer(),
                            timestepper="QuasiAdamsBashforth2")
state = jax.eval_shape(lambda: model.initial_state())
state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), state)
comp = jax.jit(model.step, donate_argnums=0).lower(state, jnp.float32(1e-4)).compile()
txt = comp.as_text()

ITEM = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
        "pred": 1, "s8": 1, "u8": 1, "c64": 8, "c128": 16}
shape_re = re.compile(r"\b(f32|f64|bf16|f16|s32|u32|s8|u8|pred|c64|c128)\[([0-9,]*)\]")
op_re = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*(.*)$")
kind_re = re.compile(r"(?:^|\s)([a-z][a-z\-]{2,})\(")
ref_re = re.compile(r"%[\w.\-]+")


def result_bytes(typestr):
    tot = 0
    for dt, dims in shape_re.findall(typestr):
        nelem = 1
        for d in dims.split(","):
            if d:
                nelem *= int(d)
        tot += nelem * ITEM[dt]
    return tot


lines = txt.splitlines()
i0 = next((k for k, l in enumerate(lines) if l.startswith("ENTRY")), None)
if i0 is None:
    sys.exit("no ENTRY computation found")
sizes, rows = {}, []
by_kind = collections.Counter()
for line in lines[i0 + 1:]:
    if line.startswith("}"):
        break
    m = op_re.match(line)
    if not m:
        continue
    name, rest = m.groups()
    rest_nometa = rest.split(", metadata=")[0].split(", calls=")[0]
    km = kind_re.search(rest_nometa)
    kind = km.group(1) if km else "?"
    # result type = text before the opcode
    rb = result_bytes(rest_nometa[:km.start()] if km else rest_nometa)
    sizes[name] = rb
    if kind in ("parameter", "constant", "tuple", "get-tuple-element",
                "bitcast", "?"):
        continue
    args = rest_nometa[km.end():]
    reads = sum(sizes.get(r, 0) for r in ref_re.findall(args))
    tot = rb + reads
    rows.append((tot, kind, name.lstrip("%")))
    by_kind[kind] += tot

rows.sort(reverse=True)
print(f"== entry computation: {len(rows)} costed instructions, "
      f"{sum(b for b, _, _ in rows)/1e9:.2f} GB touched (upper bound)")
print("== by opcode:")
for kind, b in by_kind.most_common(15):
    print(f"  {kind:28s} {b/1e9:8.3f} GB")
print(f"== top {top} instructions:")
for b, kind, name in rows[:top]:
    print(f"  {b/1e9:7.3f} GB  {kind:24s} {name}")
