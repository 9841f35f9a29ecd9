"""The plans of the grouped GEMM's two backward kernels, on the CPU.

``plan_bwd_da`` and ``plan_bwd_db`` choose each launch's persistent grid,
ring stages and tile from shapes alone (the counts live on the card);
``da_chunks`` is dA's split of an expert's kept rows, which the kernel
repeats on the card.  Shapes: qwen2-moe at training's capacity (C 344)
and at decode (C 8) for gate/up and down, deepseek-v3's 256 experts of
7,168 <-> 2,048, and the ragged widths and edge counts of the card
tests.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grouped_gemm as GG  # noqa: E402

# (E, C, K, N): A (E, C, K), the weight (E, K, N), dC (E, C, N)
SHAPES = [(60, 344, 2048, 1408), (60, 344, 1408, 2048),
          (60, 8, 2048, 1408), (60, 8, 1408, 2048),
          (256, 24, 7168, 2048), (256, 32, 7168, 2048),
          (7, 40, 136, 200), (5, 300, 264, 136), (12, 300, 1408, 2048),
          (10, 520, 264, 200), (9, 260, 136, 72), (3, 70, 40, 24),
          (1024, 344, 2048, 2048), (1, 1, 8, 8)]
# every edge of dA's chunks (160 rows, rounded to 8 up to 64 and to 32
# beyond) and of dB's 64-row stages, and C of the shapes above
COUNTS = sorted({0, 1, 7, 8, 9, 63, 64, 65, 96, 97, 159, 160, 161, 255, 256,
                 257, 320, 321, 480, 481, 24, 32, 40, 70, 260, 300, 344, 520})


def _plans(shape):
    E, C, K, N = shape
    return GG.plan_bwd_da(E, C, N, K), GG.plan_bwd_db(E, C, K, N)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bwd_plans_fit_the_shared_memory(shape):
    """Each plan's shared memory is the source's count for its stages,
    within the card's 227 KB, and one more stage would not fit (or the
    ring is at its deepest)."""
    E = shape[0]
    da, db = _plans(shape)
    for which, plan, lo, hi in ((0, da, GG.MIN_STAGES, GG.MAX_STAGES),
                                (1, db, GG.DB_MIN_STAGES, GG.DB_MAX_STAGES)):
        assert lo <= plan.stages <= hi
        assert plan.smem == GG.bwd_smem_bytes(which, E, plan.stages,
                                              plan.rows)
        assert plan.smem <= GG.SMEM_LIMIT
        assert plan.stages == hi or GG.bwd_smem_bytes(
            which, E, plan.stages + 1, plan.rows) > GG.SMEM_LIMIT


def _most_da_items(E, C, K, cols):
    """dA's items when every expert keeps all C rows, counted by brute
    force over ``da_chunks``: no routing gives more, since an expert's
    chunks never fall as its count grows."""
    chunks = [len(GG.da_chunks(c)) for c in range(C + 1)]
    assert chunks == sorted(chunks)
    return E * chunks[C] * -(-K // cols)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bwd_plans_grid_within_the_sms_and_the_items(shape):
    """The persistent grid is at most one CTA per SM and never more than
    the work items any routing can give (dA: touched experts' chunks x
    column tiles; dB: every expert's 256 x 128 tiles), so no CTA is
    launched that can have no item at every count."""
    E, C, K, N = shape
    da, db = _plans(shape)
    assert da.cols == GG.da_cols(da.rows) and (db.rows, db.cols) == (256, 128)
    assert 1 <= da.grid <= min(GG.SMS, _most_da_items(E, C, K, da.cols))
    assert 1 <= db.grid <= min(GG.SMS, E * -(-K // 256) * -(-N // 128))
    assert GG.plan_bwd_da(E, C, N, K, sms=8).grid <= 8
    assert GG.plan_bwd_db(E, C, K, N, sms=8).grid <= 8


@pytest.mark.parametrize("count", COUNTS)
def test_da_chunks_cover_every_kept_row_once(count):
    """dA's chunks of an expert's count: ceil(count / 160) of them, sizes
    within one row of each other, each at most 160, and together every
    row below the count exactly once (a brute-force tally); each chunk's
    rows rounded as wgmma's N side pad at most 7 rows to 64 and 31
    beyond, within the token ring of any buffer that holds the count."""
    chunks = GG.da_chunks(count)
    assert len(chunks) == -(-count // GG.DA_CHUNK)
    seen = [0] * count
    for row0, rows in chunks:
        assert 1 <= rows <= GG.DA_CHUNK
        for r in range(row0, row0 + rows):
            seen[r] += 1
    assert seen == [1] * count
    sizes = [rows for _, rows in chunks]
    assert not sizes or max(sizes) - min(sizes) <= 1
    for C in {count, 344, 520}:
        if C < max(count, 1):
            continue
        nt_max = GG.plan_bwd_da(60, C, 1408, 2048).rows
        for rows in sizes:
            nt = GG._round_rows(rows)
            assert rows <= nt <= nt_max and nt % 8 == 0
            assert nt - rows <= (7 if rows <= 64 else 31)


@pytest.mark.parametrize("shape,strides,want", [
    ((1, 5, 64), None, (64, 320)),            # one expert: its stride
    ((4, 1, 24), None, (24, 24)),             # one row a buffer
    ((4, 6, 64), (0, 64, 1), (64, 384)),      # broadcast: copied once
    ((4, 6, 64), (64, 256, 1), (256, 64)),    # heads of a token-major view
])
def test_bwd_operand_strides_for_the_tensor_maps(shape, strides, want):
    """The (row, expert) strides the wrappers hand the tensor maps: a
    dimension of one gets a contiguous tensor's stride, an operand
    broadcast over the experts (stride 0, which a map cannot take) is
    copied once, and any other layout passes as it is."""
    base = torch.arange(4 * 6 * 64 * 4, dtype=torch.float32)
    # defined values only: uninitialised memory may hold NaN, which
    # ``torch.equal`` never finds equal to itself
    t = base[:torch.Size(shape).numel()].reshape(shape) if strides is None \
        else base.as_strided(shape, strides)
    got, ld, se = GG._strides(t)
    assert (ld, se) == want
    assert torch.equal(got, t)
