"""The exact matcher at the widened shapes, and the kernel's admission rule.

The plain solver (``hungarian_lap_reference``, the arithmetic the CUDA
kernel repeats) against the Pallas kernel run through the interpreter and
against scipy at shapes past the old 256-column cap; and
``kernel_plan`` (which shapes the kernel takes, how many column slots a
lane or a thread holds, its shared memory, its threads) against the C source
``boosted_detr_torch/csrc/lap.cu``, which states the same rule. Costs are
random floats, so they are tie-free and the optimal assignment is unique.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from boosted_detr_torch.ops import lap as tlap
from boosted_detr_tpu.ops.pallas_lap import hungarian_lap_pallas

torch.set_num_threads(2)

SOURCE = (Path(tlap.__file__).resolve().parents[1] / "csrc"
          / "lap.cu").read_text()


@pytest.mark.parametrize("b,o,p", [(2, 32, 300), (2, 120, 140)])
def test_plain_solver_gives_the_pallas_kernels_mask_at_wide_shapes(b, o, p):
    rng = np.random.default_rng(o + p)
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = np.array([o, o // 3], np.int32)
    ours = tlap.hungarian_lap_reference(torch.from_numpy(cost),
                                        torch.from_numpy(n)).numpy()
    ref = np.asarray(hungarian_lap_pallas(jnp.asarray(cost), jnp.asarray(n),
                                          interpret=True))
    np.testing.assert_array_equal(ours, ref)


def test_plain_solver_is_optimal_at_100_by_300():
    rng = np.random.default_rng(100)
    b, o, p = 2, 100, 300
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = np.array([o, 37], np.int32)
    mask = tlap.hungarian_lap_reference(torch.from_numpy(cost),
                                        torch.from_numpy(n)).numpy()
    for i in range(b):
        ni = int(n[i])
        np.testing.assert_array_equal(mask[i, ni:], 0.0)
        np.testing.assert_array_equal(mask[i, :ni].sum(1), 1.0)
        assert (mask[i].sum(0) <= 1).all()
        r, c = linear_sum_assignment(cost[i, :ni])
        # rtol 1e-5, atol 1e-3: the JAX kernel test's tolerance
        assert np.isclose((mask[i] * cost[i]).sum(), cost[i][r, c].sum(),
                          rtol=1e-5, atol=1e-3)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _choices(name):
    return [int(s) for s in re.search(
        rf"constexpr int {name}\[\] = \{{([^}}]*)\}};", SOURCE)
        .group(1).split(",")]


def _c_plan(o, p):
    """The C source's rule, read from its text: ``slots_for``'s and
    ``column_slots_for``'s choices, ``lap_solve``'s limits, the threads a
    block of each route, ``lap_smem_bytes``'s and ``columns_bytes``'s
    formulas. (route, slots, smem, scratch, threads), or None where it
    refuses."""
    warp = _constant("WARP")
    if not (0 < o <= _constant("MAX_OBJECTS") and p > 0):
        return None
    slots = next((s for s in _choices("SLOT_CHOICES")
                  if p + o + 1 <= warp * s), 0)
    body = re.search(r"long long lap_smem_bytes\(int O, int P\) \{\s*"
                     r"return ([^;]*);", SOURCE).group(1)
    expr = (body.replace("4LL", "4").replace("static_cast<long long>(O)", "O")
            .replace("slots_for(O, P)", "slots").replace("WARP", str(warp)))
    smem = eval(expr, {}, {"O": o, "P": p, "slots": slots})  # noqa: S307
    if slots and smem <= _constant("SMEM_LIMIT"):
        return "slots", slots, smem, 0, _constant("THREADS")
    threads = _constant("COLUMN_THREADS")
    c_expr, rounded = re.search(
        r"long long columns_bytes\(int O, int P\) \{\s*"
        r"const long long C = ([^;]*);\s*return ([^;]*);", SOURCE).groups()
    columns = eval(c_expr.replace("static_cast<long long>(P)", "P"),  # noqa: S307
                   {}, {"O": o, "P": p})
    k = next((s for s in _choices("COLUMN_SLOT_CHOICES")
              if columns <= threads * s), 0)
    if k:
        return "columns", k, 0, 0, threads
    state = eval(rounded.replace("/", "//"), {}, {"C": columns})  # noqa: S307
    return "columns_global", 0, 0, state, threads


@pytest.mark.parametrize("o,p", [
    (32, 96), (32, 300), (120, 300), (32, 990), (100, 120), (4, 8),
    (1, 1), (120, 1), (31, 96), (32, 127), (33, 126), (64, 64),
    (120, 400), (120, 420), (120, 480), (121, 8), (32, 991), (32, 992),
    (1, 1022), (1, 1023), (60, 800), (100, 480), (128, 100), (120, 900),
    (64, 2000), (8, 20000),
    # the columns route's register slots, one column below, at and above
    # each multiple of its 256 threads: C = 767-769 ... 4095-4097
    (120, 646), (120, 647), (120, 648), (120, 902), (120, 903), (120, 904),
    (120, 1414), (120, 1415), (120, 1416), (120, 1926), (120, 1927),
    (120, 1928), (120, 2438), (120, 2439), (120, 2440), (120, 2950),
    (120, 2951), (120, 2952), (120, 3974), (120, 3975), (120, 3976),
    (1, 4094), (1, 4095)])
def test_kernel_plan_is_the_c_sources_rule(o, p):
    want = _c_plan(o, p)
    if want is None:
        with pytest.raises(ValueError, match="hungarian_lap: "):
            tlap.kernel_plan(o, p)
        return
    plan = tlap.kernel_plan(o, p)
    assert tuple(plan) == want
    assert plan.smem <= tlap.SMEM_LIMIT
    assert tlap.SLOT_CHOICES == tuple(_choices("SLOT_CHOICES"))
    assert tlap.COLUMN_SLOT_CHOICES == tuple(_choices("COLUMN_SLOT_CHOICES"))
    assert (tlap.MAX_OBJECTS, tlap.SMEM_LIMIT, tlap.THREADS,
            tlap.COLUMN_THREADS) == (
        _constant("MAX_OBJECTS"), _constant("SMEM_LIMIT"),
        _constant("THREADS"), _constant("COLUMN_THREADS"))


@pytest.mark.parametrize("b,o,p,slots", [
    (8, 32, 96, 5),     # the flagship: C = 129
    (32, 32, 96, 5),    # four boosted blocks folded into one launch
    (8, 32, 300, 12),   # num_object_preds=300: C = 333
    (4, 120, 300, 16),  # C = 421
    (2, 32, 990, 32),   # C = 1023
    (2, 100, 120, 8),   # C = 221
])
def test_kernel_plan_at_the_main_and_widened_shapes(b, o, p, slots):
    plan = tlap.kernel_plan(o, p)
    assert plan.route == "slots" and plan.slots == slots
    assert 32 * plan.slots >= p + o + 1 > 32 * max(
        [s for s in tlap.SLOT_CHOICES if s < plan.slots], default=0)


@pytest.mark.parametrize("o,p,route,why,slots", [
    # C = 1025: past the 32 register slots of a lane
    (32, 992, "columns", "columns", 6),
    # C = 601, but 120 x 480 cost rows take 236,544 bytes
    (120, 480, "columns", "cost rows", 3),
    # DINO's 900 queries at max_objects=120: 432,000 bytes of cost rows;
    # C = 1021, four columns a thread
    (120, 900, "columns", "cost rows", 4),
    (64, 2000, "columns", "columns", 10),  # C = 2065
    (120, 3975, "columns", "columns", 16),  # C = 4096: the most in registers
    # past 16 columns a thread: the column state in device memory
    (120, 3976, "columns_global", "column state", 0),
    (8, 20000, "columns_global", "column state", 0),
])
def test_kernel_plan_takes_the_columns_route_past_the_slots(o, p, route,
                                                            why, slots):
    plan = tlap.kernel_plan(o, p)
    assert plan.route == route and plan.slots == slots
    assert plan.threads == tlap.COLUMN_THREADS
    columns = p + o + 1
    state = tlap.columns_bytes(o, p)
    assert state >= 17 * columns and state % 16 == 0
    if why == "columns":
        assert columns > 32 * tlap.SLOT_CHOICES[-1]
    elif why == "cost rows":
        assert columns <= 32 * tlap.SLOT_CHOICES[-1]
        assert 4 * o * p > tlap.SMEM_LIMIT - 4 * 2 * 32 * 32
    if route == "columns":
        # the fewest slots a thread that hold C
        assert (plan.smem, plan.scratch) == (0, 0)
        fewer = max([s for s in tlap.COLUMN_SLOT_CHOICES if s < slots],
                    default=0)
        assert tlap.COLUMN_THREADS * slots >= columns
        assert columns > tlap.COLUMN_THREADS * fewer
    else:
        assert (plan.smem, plan.scratch) == (0, state)
        assert columns > tlap.COLUMN_THREADS * tlap.COLUMN_SLOT_CHOICES[-1]


@pytest.mark.parametrize("o,p", [
    (32, 96), (33, 96), (1, 1022), (120, 300), (32, 992), (120, 480),
    (120, 900), (64, 2000), (120, 3975), (120, 3976), (8, 20000)])
def test_kernel_name_is_the_c_sources_dispatch(o, p):
    """``kernel_name`` (what ``chip_smoke.py`` holds a profile to) against
    ``lap.cu``'s dispatch: the slots route's row slots by O, the columns
    route's template argument by its register slots (0 past them)."""
    plan = tlap.kernel_plan(o, p)
    name = tlap.kernel_name(o, p)
    if plan.route == "slots":
        few, many = re.search(r"O <= WARP \? launch<S, (\d+)>\(.*?\)\s*"
                              r": launch<S, (\d+)>\(", SOURCE,
                              flags=re.S).groups()
        rows = few if o <= _constant("WARP") else many
        assert name == f"lap_kernel<{plan.slots}, {rows}>"
        return
    cases = dict(re.findall(r"case (\d+):\s*return launch_columns<(\d+)>",
                            SOURCE))
    default = re.search(r"default:\s*return launch_columns<(\d+)>",
                        SOURCE).group(1)
    assert sorted(map(int, cases)) == sorted(tlap.COLUMN_SLOT_CHOICES)
    assert name == f"lap_columns_kernel<{cases.get(str(plan.slots), default)}>"
    assert plan.slots or default == "0"


@pytest.mark.parametrize("o,p,limit", [(121, 8, "O <= 120 rows")])
def test_kernel_plan_names_the_limit(o, p, limit):
    with pytest.raises(ValueError, match=limit):
        tlap.kernel_plan(o, p)


@pytest.mark.parametrize("b,o,p", [(2, 120, 900), (1, 64, 2000)])
def test_plain_solver_is_optimal_on_the_columns_route(b, o, p):
    """DINO's 900 queries at 120 objects, and C = 2065: the shapes the
    columns route takes, against scipy."""
    rng = np.random.default_rng(o * p)
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = np.array([o, o // 2][:b], np.int32)
    mask = tlap.hungarian_lap_reference(torch.from_numpy(cost),
                                        torch.from_numpy(n)).numpy()
    for i in range(b):
        ni = int(n[i])
        np.testing.assert_array_equal(mask[i, ni:], 0.0)
        np.testing.assert_array_equal(mask[i, :ni].sum(1), 1.0)
        assert (mask[i].sum(0) <= 1).all()
        r, c = linear_sum_assignment(cost[i, :ni])
        assert np.isclose((mask[i] * cost[i]).sum(), cost[i][r, c].sum(),
                          rtol=1e-5, atol=1e-3)


def test_plain_solver_gives_the_pallas_kernels_mask_past_the_slots():
    """[1, 120, 900], which the columns route takes: the plain version
    (the kernels' arithmetic) against the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(900)
    cost = rng.uniform(0, 10, (1, 120, 900)).astype(np.float32)
    n = np.array([97], np.int32)
    ours = tlap.hungarian_lap_reference(torch.from_numpy(cost),
                                        torch.from_numpy(n)).numpy()
    ref = np.asarray(hungarian_lap_pallas(jnp.asarray(cost), jnp.asarray(n),
                                          interpret=True))
    np.testing.assert_array_equal(ours, ref)


def test_ctypes_signatures_match_the_c_entry_points(monkeypatch):
    """Each C entry point of csrc/lap.cu takes the arguments the wrapper's
    ctypes signature passes, and returns what it reads."""
    c_types = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
               "int": ctypes.c_int}
    results = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
               "const char*": ctypes.c_char_p}
    exported = SOURCE[SOURCE.index('extern "C" {'):]
    exported = exported[:exported.index("#ifdef LAP_PHASES")]
    found = {}
    for ret, name, params in re.findall(
            r"^(int|long long|const char\*) (\w+)\(([^)]*)\)\s*\{", exported,
            flags=re.M):
        args = [c_types[" ".join(q.split()[:-1])]
                for q in params.replace("\n", " ").split(",")]
        found[name] = (args, results[ret])

    class FakeLibrary:
        def __init__(self):
            for fn in found:
                setattr(self, fn, type("Fn", (), {})())

    from boosted_detr_torch.ops import build
    lib = FakeLibrary()
    monkeypatch.setattr(build, "load", lambda name: lib)
    tlap._library()
    assert {fn: (getattr(lib, fn).argtypes, getattr(lib, fn).restype)
            for fn in found} == found
