"""The port's kernels, by their plain PyTorch versions, against the JAX
package's Pallas kernels (interpret mode on the CPU) and its oracles.

On finite values without -0.0 (the reference's one-hot products lose
NaN, inf and the sign of zero: ROADMAP fault F1) the two agree exactly,
over ``tests/test_kernels.py``'s shape grid.  The native-type cases the
reference refuses or rounds (int64 beyond 2**24 and 2**53, float64, NaN,
±inf, -0.0) are held against NumPy.  Every comparison is exact: each path
copies bits or compares, and no sum is reordered.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.dict_decode import ops as dd_ops
from repro.kernels.dict_decode.ref import dict_decode_ref as jax_dict_ref
from repro.kernels.predicate_fused import ops as pf_ops
from repro.kernels.predicate_fused.ref import \
    predicate_mask_ref as jax_pred_ref
from repro.kernels.token_pack import ops as tp_ops
from repro.kernels.token_pack.ref import pack_ref
from repro_torch.kernels import (block_offsets, build_program, compact,
                                 compare_type, dict_decode, pack_tokens,
                                 predicate_mask)
from repro_torch.kernels.dict_decode.ref import dict_decode_ref
from repro_torch.kernels.predicate_fused.predicate_fused import (Program,
                                                                 Term)
from repro_torch.kernels.predicate_fused.ref import predicate_mask_ref
from repro_torch.kernels.token_pack.ref import (block_counts_ref,
                                                pack_tokens_ref)

# One intra-op thread: the suite runs in several worker processes at once,
# and the tensors here are small.
torch.set_num_threads(1)

T = torch.from_numpy

SPECIAL_F = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25, 1e300]
SPECIAL_I = [0, -1, 2 ** 24 + 1, 2 ** 53 + 1, -(2 ** 62) - 7, 2 ** 63 - 1]


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# dict_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 1024, 1025, 50_000])
@pytest.mark.parametrize("d", [1, 7, 128, 2048, 2049, 60_000])
def test_dict_decode_matches_reference(n, d):
    rng = np.random.default_rng(n + d)
    dic = rng.normal(size=d).astype(np.float32)
    codes = rng.integers(0, d, n).astype(np.int32)
    got = dict_decode(T(codes), T(dic)).numpy()
    assert same_bits(got, np.asarray(dd_ops.decode_dictionary(codes, dic)))
    assert same_bits(got, np.asarray(jax_dict_ref(jnp.asarray(codes),
                                                  jnp.asarray(dic))))
    assert same_bits(got, dict_decode_ref(T(codes), T(dic)).numpy())


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_dict_decode_int_dtypes_match_reference(dtype):
    rng = np.random.default_rng(0)
    dic = rng.integers(0, 2 ** 20, 500).astype(dtype)
    codes = rng.integers(0, 500, 3000).astype(np.int32)
    got = dict_decode(T(codes), T(dic)).numpy()
    assert same_bits(got, np.asarray(dd_ops.decode_dictionary(codes, dic)))
    assert same_bits(got, dic[codes])


@pytest.mark.parametrize("values", [
    np.array(SPECIAL_F, np.float64),
    np.array(SPECIAL_F[:-1], np.float32),
    np.array(SPECIAL_I, np.int64),
    np.array([0, -1, 2 ** 31 - 1, -(2 ** 31)], np.int32),
    np.array([np.float64.fromhex("0x1.8p+1000"), 5e-324], np.float64),
], ids=["f64-special", "f32-special", "i64-wide", "i32-extremes", "f64-edge"])
def test_dict_decode_native_types(values):
    """Beyond the reference's f32 domain: bits come back unchanged (a NaN
    payload and -0.0 included)."""
    nan_payload = np.array([0x7FF0000000000123], np.uint64).view(np.float64)
    if values.dtype == np.float64:
        values = np.concatenate([values, nan_payload])
    codes = np.random.default_rng(1).integers(0, len(values),
                                              777).astype(np.int32)
    got = dict_decode(T(codes), T(values)).numpy()
    assert same_bits(got, values[codes])


@pytest.mark.parametrize("bad", [-1, 5])
def test_dict_decode_rejects_bad_codes(bad):
    codes = np.array([0, 1, bad], np.int32)
    with pytest.raises(ValueError, match="outside the dictionary"):
        dict_decode(T(codes), T(np.arange(5, dtype=np.int64)))


@pytest.mark.parametrize("codes,dic,exc", [
    (np.zeros(3, np.int64), np.zeros(2, np.int32), TypeError),
    (np.zeros(3, np.int32), np.zeros(2, np.int16), TypeError),
    (np.zeros((3, 1), np.int32), np.zeros(2, np.int32), ValueError),
], ids=["codes-int64", "dict-int16", "codes-2d"])
def test_dict_decode_wrapper_checks(codes, dic, exc):
    with pytest.raises(exc):
        dict_decode(T(codes), T(dic))


# ---------------------------------------------------------------------------
# predicate_fused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 100, 2048, 2049, 7777, 65536])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
def test_predicate_shapes_match_reference(n, dtype):
    rng = np.random.default_rng(n)
    cols = [rng.uniform(-100, 100, n).astype(dtype),
            rng.integers(0, 10, n).astype(np.int32)]
    terms = [(0, "gt", 3.0), (1, "ne", 7)]
    prog = build_program(terms, [c.dtype for c in cols], "and")
    got = predicate_mask([T(c) for c in cols], prog).numpy()
    ref = np.asarray(pf_ops.fused_predicate(
        cols, pf_ops.build_program(terms, "and")))
    assert same_bits(got.astype(bool), ref)
    assert same_bits(got.astype(bool), (cols[0] > 3.0) & (cols[1] != 7))


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
@pytest.mark.parametrize("combine", ["and", "or"])
def test_predicate_ops_match_reference(op, combine):
    rng = np.random.default_rng(3)
    cols = [rng.integers(-5, 5, 4096).astype(np.int32),
            rng.integers(-5, 5, 4096).astype(np.int32)]
    terms = [(0, op, 0), (1, "ge", 2)]
    prog = build_program(terms, [np.int32, np.int32], combine)
    got = predicate_mask([T(c) for c in cols], prog).numpy()
    stacked = jnp.stack([jnp.asarray(c, jnp.float32) for c in cols])
    exp = np.asarray(jax_pred_ref(stacked, pf_ops.build_program(terms,
                                                                combine)))
    assert same_bits(got, exp)
    assert same_bits(got, predicate_mask_ref([T(c) for c in cols],
                                             prog).numpy())


def test_predicate_negate_matches_reference():
    cols = [np.arange(2048, dtype=np.float32)]
    prog = build_program([(0, "lt", 100.0)], [np.float32], negate=True)
    got = predicate_mask([T(cols[0])], prog).numpy()
    ref = np.asarray(pf_ops.fused_predicate(
        cols, pf_ops.build_program([(0, "lt", 100.0)], negate=True)))
    assert same_bits(got.astype(bool), ref)
    assert same_bits(got.astype(bool), np.arange(2048) >= 100)


_OPS = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
        "ge": np.greater_equal, "eq": np.equal, "ne": np.not_equal}


@pytest.mark.parametrize("op", sorted(_OPS))
@pytest.mark.parametrize("col,value", [
    (np.array(SPECIAL_F, np.float64), 1.5),
    (np.array(SPECIAL_F, np.float64), np.nan),
    (np.array(SPECIAL_F, np.float64), -0.0),
    (np.array(SPECIAL_F[:-1], np.float32), 0.1),        # f32 compare
    (np.array(SPECIAL_F[:-1], np.float32), np.float64(0.1)),   # f64
    (np.array(SPECIAL_I, np.int64), 2 ** 53 + 1),       # int64 compare
    (np.array(SPECIAL_I, np.int64), 9.007199254740993e15),     # f64
    (np.array([1, 2, 3, -2 ** 31], np.int32), 2.5),     # f64 compare
    (np.array([1, 2, 3, 2 ** 31 - 1], np.int32), 2),    # int32 compare
    (np.array([1, 2, 3, 2 ** 31 - 1], np.int32), np.int64(2 ** 40)),
], ids=lambda v: str(getattr(v, "dtype", v)))
def test_predicate_compares_as_numpy(op, col, value):
    """One term, in NumPy 2's compare type: NaN is false for every
    operator but ``!=``, -0.0 equals 0.0, int64 beyond 2**53 is exact."""
    prog = build_program([(0, op, value)], [col.dtype])
    got = predicate_mask([T(col)], prog).numpy().astype(bool)
    assert same_bits(got, _OPS[op](col, value))


@pytest.mark.parametrize("dtype,value,ctype", [
    (np.float32, 40.0, np.float32),
    (np.float32, np.float64(40.0), np.float64),
    (np.int32, 40.0, np.float64),
    (np.int32, 2, np.int32),
    (np.int64, 2, np.int64),
    (np.int32, np.int64(2), np.int64),
    (np.float64, 2, np.float64),
    (np.int32, 2 ** 40, None),          # does not fit the column's type
    (np.bool_, True, None),             # bool compare
    (np.int32, "2", None),              # not numeric
    (np.float32, 1j, None),             # complex compare
])
def test_compare_type(dtype, value, ctype):
    got = compare_type(np.dtype(dtype), value)
    assert got == (None if ctype is None else np.dtype(ctype))


def test_predicate_wrapper_checks():
    col = T(np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="terms"):
        Program(())
    with pytest.raises(ValueError):
        build_program([(0, "lt", 2 ** 40)], [np.int32])
    prog = build_program([(1, "lt", 2)], [np.int32, np.int32])
    with pytest.raises(ValueError, match="term column"):
        predicate_mask([col], prog)
    with pytest.raises(TypeError):
        predicate_mask([col.to(torch.int16)],
                       Program((Term(0, "lt", np.dtype(np.int32), 2),)))
    with pytest.raises(ValueError, match="columns"):
        predicate_mask([col] * 9, prog)


# ---------------------------------------------------------------------------
# token_pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 511, 512, 513, 10_000])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_pack_tokens_matches_reference(n, density):
    rng = np.random.default_rng(int(n + density * 10))
    vals = rng.integers(0, 2 ** 20, n).astype(np.int32)
    mask = rng.random(n) < density
    cap = max(64, n // 2)
    got, cnt = pack_tokens(T(vals), T(mask), cap)
    ref, ref_cnt = tp_ops.pack_tokens(vals, mask, cap)
    assert cnt == int(ref_cnt) == pack_ref(vals, mask, cap)[1]
    assert same_bits(got.numpy(), np.asarray(ref))
    assert same_bits(got.numpy(), pack_ref(vals, mask, cap)[0])
    exp, exp_cnt = pack_tokens_ref(T(vals), T(mask), cap)
    assert cnt == exp_cnt and same_bits(got.numpy(), exp.numpy())


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
def test_block_offsets(n):
    mask = np.random.default_rng(n).random(n) < 0.3
    offsets, total = block_offsets(T(mask))
    per_block = [int(mask[i:i + 1024].sum()) for i in range(0, n, 1024)]
    assert total == int(mask.sum())
    assert offsets.tolist() == list(np.cumsum([0] + per_block[:-1]))
    assert block_counts_ref(T(mask)).tolist() == per_block


@pytest.mark.parametrize("values", [
    np.array(SPECIAL_F * 300, np.float64),
    np.array(SPECIAL_F[:-1] * 300, np.float32),
    np.array(SPECIAL_I * 300, np.int64),
    np.arange(2400, dtype=np.int32) - 1200,
    np.arange(2400) % 3 == 0,
], ids=["f64", "f32", "i64", "i32", "bool"])
def test_compact_native_types(values):
    mask = np.random.default_rng(7).random(len(values)) < 0.4
    offsets, count = block_offsets(T(mask))
    got = compact(T(values), T(mask), offsets, count).numpy()
    assert same_bits(got, values[mask])


def test_pack_preserves_order():
    vals = np.arange(2000, dtype=np.int32)
    mask = vals % 3 == 0
    got, cnt = pack_tokens(T(vals), T(mask), 1024)
    kept = got.numpy()[:cnt]
    assert same_bits(kept, vals[mask][:1024])
    assert (np.diff(kept) > 0).all()


def test_token_pack_wrapper_checks():
    vals = T(np.arange(10, dtype=np.int32))
    with pytest.raises(TypeError, match="mask"):
        block_offsets(vals)
    mask = T(np.ones(9, bool))
    offsets, count = block_offsets(mask)
    with pytest.raises(ValueError, match="shape"):
        compact(vals, mask, offsets, count)
    with pytest.raises(TypeError):
        compact(vals.to(torch.int16)[:9], mask, offsets, count)
