"""Compiled-HLO collective structure of the sharded DCRT pipelines.

The scaling design (SURVEY.md §5, mesh.py): the residue axis is
embarrassingly parallel through NTTs and pointwise ops — a residue-sharded
DCRT NTT must compile to ZERO collectives — while the CRT compose inside
the gadget product is the one cross-residue contraction and must lower to
residue-group collectives.  These assertions pin the partitioner's output
so sharding regressions fail in CI rather than as silent slowdowns on a
mesh.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from primus_fhe_tpu.numeric import to_u64_pair
from primus_fhe_tpu.parallel.mesh import make_mesh

pytestmark = pytest.mark.slow

MODULI = [1125899906826241, 1125899906629633]

_COLLECTIVES = re.compile(
    r"\b(all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter)\b"
)


def _collective_ops(compiled_text: str) -> list[str]:
    return _COLLECTIVES.findall(compiled_text)


_DTYPE_BYTES = {
    "u8": 1, "s8": 1, "pred": 1, "u16": 2, "s16": 2, "bf16": 2, "f16": 2,
    "u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8, "f64": 8,
}
_OP = re.compile(
    r"=\s+(\([^)]*\)|\w+\[[\d,]*\][^ ]*)\s+"
    r"(all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter)"
    r"(?:-start)?\("
)
_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS = re.compile(r"replica_groups=\{\{([^}]*)\}")


def parse_collective_bytes(txt: str, scan_trips: int) -> dict:
    """Tally per-device collective wire bytes from optimized-HLO text.
    ``scan_trips`` multiplies collectives inside while bodies (the scan
    over LWE positions prints its body once)."""
    per_line = []
    for line in txt.splitlines():
        m = _OP.search(line)
        if not m:
            continue
        shapes, kind = m.group(1), m.group(2)
        size = 0
        for dtype, dims in _SHAPE.findall(shapes):
            if dtype not in _DTYPE_BYTES:
                continue
            s = _DTYPE_BYTES[dtype]
            for d in dims.split(","):
                if d:
                    s *= int(d)
            size += s
        if not size:
            continue
        gm = _GROUPS.search(line)
        g = len(gm.group(1).split(",")) if gm else 2
        trips = scan_trips if "while" in line else 1
        if kind == "all-reduce":
            wire = 2 * (g - 1) / g * size
        elif kind == "all-gather":
            wire = (g - 1) / g * size
        elif kind == "reduce-scatter":
            wire = (g - 1) * size
        else:  # collective-permute / all-to-all: send one shard
            wire = size
        per_line.append({"kind": kind, "wire": wire * trips})
    by_kind: dict = {}
    for r in per_line:
        a = by_kind.setdefault(r["kind"], {"count": 0, "wire_bytes": 0.0})
        a["count"] += 1
        a["wire_bytes"] += r["wire"]
    return {"by_kind": by_kind,
            "total_wire_bytes": sum(r["wire"] for r in per_line)}


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8, residue=2)


def test_residue_sharded_ntt_has_no_collectives(mesh):
    """Residue-sharded DCRT forward+inverse: zero-communication SPMD."""
    from primus_fhe_tpu.transforms.dcrt import (
        build_dcrt_plan64,
        dcrt_forward64,
        dcrt_inverse64,
    )

    log_n = 6
    plan = build_dcrt_plan64(log_n, MODULI)
    sh = NamedSharding(mesh, P("residue", "batch", None))
    vals = to_u64_pair(
        np.random.default_rng(0).integers(
            0, min(MODULI), size=(2, 8, 1 << log_n), dtype=np.uint64
        )
    )

    for fn in (dcrt_forward64, dcrt_inverse64):
        f = jax.jit(
            lambda v, fn=fn: fn(plan, v), in_shardings=(sh,), out_shardings=sh
        )
        txt = f.lower(vals).compile().as_text()
        ops = _collective_ops(txt)
        assert not ops, f"{fn.__name__} leaked collectives: {ops[:5]}"


def test_rotation_step_collectives_are_residue_compose_only(mesh):
    """The sharded blind-rotation step communicates ONLY for the CRT
    compose: residue-group collectives present, no all-to-all, and no
    collective touches the batch (data-parallel) axis."""
    from __graft_entry__ import make_sharded_rotation_step

    step, (lwe, acc, bsk), _ = make_sharded_rotation_step(
        8, log_n=6, n_lwe=2, batch=16
    )
    txt = step.lower(lwe, acc, bsk).compile().as_text()
    ops = _collective_ops(txt)
    assert ops, "expected residue-axis collectives at CRT compose"
    assert "all-to-all" not in ops, "unexpected all-to-all in rotation step"
    # batch axis = mesh dim 1 (devices {0..3} vs {4..7} are the residue
    # groups): every replica group must stay within one batch rank, i.e.
    # groups pair devices d and d+4 (same batch index, both residues).
    groups = re.findall(r"replica_groups=\{\{([0-9,]+)\}", txt)
    for g in groups:
        ids = sorted(int(x) for x in g.split(","))
        assert len(ids) <= 2 and (len(ids) == 1 or ids[1] - ids[0] == 4), (
            f"collective crosses the batch axis: group {ids}"
        )


def test_coeff_sharded_one_permute_per_exchange_stage(mesh):
    """Every coefficient-sharded exchange stage is ONE XOR-partner swap:
    the compiled program must contain exactly log2(D) collective-permutes
    per transform per value plane (u32: 1 plane, u64: 2) — the +delta /
    -delta double-ppermute formulation would show 2x that."""
    from primus_fhe_tpu.parallel.coeff_sharded import (
        _fwd32_fn,
        _fwd64_fn,
        _inv32_fn,
        _inv64_fn,
        _default_tables32,
        _default_inv_tables32,
        _default_tables64,
        _default_inv_tables64,
    )

    log_n, q32 = 8, 536813569
    q64 = MODULI[0]
    d = 4
    # a 1-D coeff mesh over 4 devices
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()[:d])
    cmesh = Mesh(devs, ("coeff",))
    log_d = 2

    rng = np.random.default_rng(5)
    v32 = jnp.asarray(
        rng.integers(0, q32, size=(2, 1 << log_n), dtype=np.uint64).astype(
            np.uint32
        )
    )
    v64 = to_u64_pair(
        rng.integers(0, q64, size=(2, 1 << log_n), dtype=np.uint64)
    )

    def count_permutes(fn, *args):
        txt = fn.lower(*args).compile().as_text()
        return len(re.findall(r"collective-permute(?:-start)?\(", txt))

    w32, p32 = _default_tables32(log_n, q32)
    iw32, ip32 = _default_inv_tables32(log_n, q32)
    w64, p64 = _default_tables64(log_n, q64)
    iw64, ip64 = _default_inv_tables64(log_n, q64)

    f32 = _fwd32_fn(cmesh, "coeff", log_n, q32, 2, "jnp")
    assert count_permutes(f32, v32, w32, p32) == log_d
    i32 = _inv32_fn(cmesh, "coeff", log_n, q32, 2, "jnp")
    assert count_permutes(i32, v32, iw32, ip32) == log_d
    f64 = _fwd64_fn(cmesh, "coeff", log_n, q64, 2, "jnp")
    assert (
        count_permutes(f64, v64.lo, v64.hi, w64.lo, w64.hi, p64.lo, p64.hi)
        == 2 * log_d
    )
    i64 = _inv64_fn(cmesh, "coeff", log_n, q64, 2, "jnp")
    assert (
        count_permutes(i64, v64.lo, v64.hi, iw64.lo, iw64.hi, ip64.lo, ip64.hi)
        == 2 * log_d
    )


def test_production_step_wire_bytes_bounded(mesh):
    """Per-device collective wire bytes of the explicit production
    blind-rotation step stay within the budget behind the modeled
    8-device budget: the CRT composes run
    as reduce-scatter (16-bit halves) + all-gather (packed u32) pairs,
    ~250 KB/device per LWE scan trip.  A sharding regression that
    re-introduces redundant collectives (replicated compose all-gathers,
    double-ppermute exchanges) fails here."""
    from __graft_entry__ import make_sharded_rotation_step

    step, (lwe, acc, bsk), _ = make_sharded_rotation_step(
        8, log_n=10, n_lwe=4, batch=16, residue=2
    )
    txt = step.lower(lwe, acc, bsk).compile().as_text()
    got = parse_collective_bytes(txt, scan_trips=4)
    kinds = set(got["by_kind"])
    assert kinds <= {"reduce-scatter", "all-gather", "all-reduce"}, kinds
    assert "collective-permute" not in kinds
    assert got["total_wire_bytes"] <= 1_100_000, got["by_kind"]
