"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU (sm_90a) and the CUDA toolkit; elsewhere every
test skips.  On such a machine, from the root of the checkout:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Every comparison is bit for bit: the kernels copy bits or compare.
"""

import numpy as np
import pytest
import torch

from repro_torch.aformat.decode import NumPyBackend, TorchBackend
from repro_torch.aformat import parquet
from repro_torch.aformat.expressions import IsIn, field
from repro_torch.aformat.table import Table
from repro_torch.kernels import build_program, predicate_mask
from repro_torch.kernels.dict_decode import dict_decode as dd
from repro_torch.kernels.dict_decode.ref import dict_decode_ref
from repro_torch.kernels.predicate_fused import predicate_fused as pf
from repro_torch.kernels.predicate_fused.ref import predicate_mask_ref
from repro_torch.kernels.token_pack import token_pack as tp
from repro_torch.kernels.token_pack.ref import (block_counts_ref, compact_ref,
                                                pack_tokens_ref)

pytestmark = pytest.mark.gpu

F64 = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25, 1e300,
                np.array([0x7FF0000000000123], np.uint64).view(np.float64)[0]])
I64 = np.array([0, -1, 2 ** 53 + 1, 2 ** 53 + 2, -(2 ** 62) - 7,
                2 ** 63 - 1, 2 ** 24 + 1], np.int64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bits(t: torch.Tensor) -> bytes:
    return t.cpu().contiguous().view(torch.uint8).numpy().tobytes()


def pool(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "float64":
        return rng.choice(F64, n)
    if dtype == "float32":
        return rng.choice(F64[:7], n).astype(np.float32)
    if dtype == "int64":
        return rng.choice(I64, n)
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int32)
    return rng.random(n) < 0.5


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32"])
@pytest.mark.parametrize("d", [1, 97, 6144, 6145, 100_000])
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_dict_decode_matches_plain(cuda, dtype, d, n):
    """Both sides of the 48 KB shared-memory cut, for 4- and 8-byte
    elements, ragged lengths."""
    dic = torch.from_numpy(pool(dtype, d, d)).to(cuda)
    codes = torch.from_numpy(np.random.default_rng(n).integers(
        0, d, n).astype(np.int32)).to(cuda)
    before = dd.LAUNCHES
    got = dd.dict_decode(codes, dic)
    assert dd.LAUNCHES == before + 1
    assert got.dtype == dic.dtype and got.is_cuda
    assert bits(got) == bits(dict_decode_ref(codes, dic))


@pytest.mark.parametrize("bad", [-1, 97])
def test_dict_decode_raises_on_bad_code(cuda, bad):
    codes = torch.zeros(5000, dtype=torch.int32, device=cuda)
    codes[4321] = bad
    with pytest.raises(ValueError, match="outside the dictionary"):
        dd.dict_decode(codes, torch.arange(97, device=cuda))


def test_wrappers_never_fall_back(cuda):
    """A CUDA tensor the kernel does not take raises; it is not sent to
    the plain version."""
    codes = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        dd.dict_decode(codes, torch.zeros(4, dtype=torch.int16, device=cuda))
    with pytest.raises(ValueError):
        dd.launch(codes[::2], torch.zeros(4, device=cuda),
                  torch.empty(5, device=cuda),
                  torch.zeros(1, dtype=torch.int32, device=cuda))


PROGRAMS = {
    "and": ([(0, "gt", 1.5), (1, "ne", -0.0), (3, "ge", 0)], "and", False),
    "or-not": ([(0, "ne", float("nan")), (2, "lt", 2 ** 53 + 2)], "or",
               True),
    "f32-inexact": ([(1, "lt", 0.1), (1, "ge", -np.inf)], "and", False),
    "i32-vs-float": ([(3, "gt", 2.5), (2, "eq", -1), (0, "le", 1e300)],
                     "or", False),
    "all-ops": ([(0, op, 1.5) for op in pf.OPS]
                + [(2, op, 2 ** 53 + 1) for op in pf.OPS], "or", False),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_predicate_matches_plain(cuda, name, n):
    dtypes = ["float64", "float32", "int64", "int32"]
    cols_np = [pool(d, n, i) for i, d in enumerate(dtypes)]
    cols = [torch.from_numpy(c).to(cuda) for c in cols_np]
    terms, combine, negate = PROGRAMS[name]
    prog = build_program(terms, [c.dtype for c in cols_np], combine, negate)
    before = pf.LAUNCHES
    got = predicate_mask(cols, prog)
    assert pf.LAUNCHES == before + 1
    assert bits(got) == bits(predicate_mask_ref(cols, prog))
    ops = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
           "ge": np.greater_equal, "eq": np.equal, "ne": np.not_equal}
    want = None
    for col, op, value in terms:
        m = ops[op](cols_np[col], value)
        want = m if want is None else (want & m if combine == "and"
                                       else want | m)
    if negate:
        want = ~want
    assert np.array_equal(got.cpu().numpy().astype(bool), want)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32",
                                   "bool"])
@pytest.mark.parametrize("n,density", [(1, 1.0), (1023, 0.5),
                                       (300_001, 0.03), (300_001, 0.0),
                                       (65_536, 1.0)])
def test_compact_matches_plain(cuda, dtype, n, density):
    values = torch.from_numpy(pool(dtype, n, n)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(n + 1).random(n)
                            < density).to(cuda)
    offsets, count = tp.block_offsets(mask)
    counts = block_counts_ref(mask)
    assert bits(offsets) == bits(torch.cumsum(counts, 0) - counts)
    assert count == int(mask.sum())
    got = tp.compact(values, mask, offsets, count)
    assert bits(got) == bits(compact_ref(values, mask))


@pytest.mark.parametrize("capacity", [1, 100, 5000])
def test_pack_tokens_matches_plain(cuda, capacity):
    values = torch.from_numpy(pool("float64", 20_000, 3)).to(cuda)
    mask = torch.from_numpy(np.random.default_rng(4).random(20_000)
                            < 0.1).to(cuda)
    got, kept = tp.pack_tokens(values, mask, capacity)
    want, want_kept = pack_tokens_ref(values, mask, capacity)
    assert kept == want_kept
    assert bits(got) == bits(want)


@pytest.mark.parametrize("pred", [
    None,
    (field("cat") >= 2) & (field("f64") < 5.0),
    ~((field("cat") == 1) | (field("wide") > 2 ** 53)),
    field("f32") != 1.5,
    IsIn("cat", [1, 3, 5]),
], ids=["none", "and", "not-or", "nan-ne", "isin"])
def test_card_backend_matches_numpy(cuda, pred):
    """A row group through ``TorchBackend("cuda")`` is byte-identical to
    ``NumPyBackend``, NaN, ±inf, -0.0 and wide int64 included."""
    rng = np.random.default_rng(0)
    n = 50_000
    tbl = Table.from_pydict({
        "seq": np.arange(n, dtype=np.int64),
        "cat": rng.integers(0, 8, n).astype(np.int32),
        "f32": rng.choice(F64[:6], n).astype(np.float32),
        "f64": rng.choice(F64, n),
        "wide": rng.choice(I64, n),
        "pay": rng.choice(["card", "cash"], n),
        "flag": rng.random(n) < 0.5,
    })
    data = parquet.write_table(tbl, row_group_rows=20_000)
    src = parquet.BytesSource(data)
    meta = parquet.read_footer(src)
    card, host = TorchBackend("cuda"), NumPyBackend()
    for rg in meta.row_groups:
        report = {}
        got = card.scan_row_group(src, meta, rg, None, pred, report=report)
        want = host.scan_row_group(src, meta, rg, None, pred)
        assert report["columns"]["cat"] == "kernel"
        for a, b in zip(want.columns, got.columns):
            assert a.values.dtype == b.values.dtype, a.field.name
            if a.field.type == "string":
                assert a.values.tolist() == b.values.tolist()
            else:
                assert a.values.tobytes() == b.values.tobytes(), a.field.name
