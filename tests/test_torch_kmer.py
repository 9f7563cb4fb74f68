"""PyTorch port vs the JAX package: DNA words, segments, k-mer extraction.

Inputs are made with numpy from fixed seeds and handed to both packages;
integer results must be bit-equal (the port's int64 words against the
JAX package's uint32 words).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: more intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.ops import dna as jdna  # noqa: E402
from spades_for_blackbird_tpu.ops import kmer as jkmer  # noqa: E402
from spades_for_blackbird_tpu.ops import kmer_pallas  # noqa: E402
from spades_for_blackbird_tpu.ops import segments as jseg  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import chunking  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import (  # noqa: E402
    dna, kmer, kmer_cuda)
from spades_for_blackbird_tpu_torch.ops import segments  # noqa: E402

EXTRACT_KS = [21, 33, 55, 77, 127]


def u32(t):
    return t.cpu().numpy().astype(np.uint32)


def reads_with_n(seed, R=12, L=150, min_len=None):
    """Random reads with N bases and short (padded) reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L), dtype=np.uint8)
    codes[rng.random((R, L)) < 0.01] = dna.INVALID_CODE
    lengths = np.full(R, L, np.int32)
    lengths[1] = min_len if min_len is not None else L // 2
    lengths[3] = 3
    codes[np.arange(L)[None, :] >= lengths[:, None]] = dna.INVALID_CODE
    return codes, lengths


@pytest.mark.parametrize("k", EXTRACT_KS + [16, 32, 128])
def test_word_ops_match_jax(k):
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, (64, k), dtype=np.uint8)
    words = dna.pack_kmers(torch.from_numpy(bases), k)
    jwords = jdna.pack_kmers(jnp.asarray(bases), k)
    assert np.array_equal(u32(words), np.asarray(jwords))
    assert np.array_equal(dna.unpack_kmers(words, k).numpy(), bases)
    assert np.array_equal(u32(dna.revcomp_kmers(words, k)),
                          np.asarray(jdna.revcomp_kmers(jwords, k)))
    canon, fwd = dna.canonicalize_kmers(words, k)
    jcanon, jfwd = jdna.canonicalize_kmers(jwords, k)
    assert np.array_equal(u32(canon), np.asarray(jcanon))
    assert np.array_equal(fwd.numpy(), np.asarray(jfwd))
    assert np.array_equal(u32(dna.drop_first_bases(words, 1, k)),
                          np.asarray(jdna.drop_first_bases(jwords, 1, k)))
    assert np.array_equal(u32(dna.truncate_bases(words, k, k - 1)),
                          np.asarray(jdna.truncate_bases(jwords, k, k - 1)))
    base = rng.integers(0, 4, 64).astype(np.uint8)
    assert np.array_equal(
        u32(dna.append_base(words, k, torch.from_numpy(base))),
        np.asarray(jdna.append_base(jwords, k, jnp.asarray(base))))
    assert np.array_equal(dna.kmer_last_base(words, k).numpy(),
                          np.asarray(jdna.kmer_last_base(jwords, k)))


@pytest.mark.parametrize("k", EXTRACT_KS)
def test_extract_canonical_matches_jax(k):
    codes, lengths = reads_with_n(k)
    canon, valid, fwd = kmer.extract_canonical_kmers(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    jc, jv, jf = jkmer.extract_canonical_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    assert np.array_equal(u32(canon), np.asarray(jc))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(fwd.numpy(), np.asarray(jf))


def unfused(keys, k):
    """(G, N) sort keys -> (N, W) uint32 words."""
    return u32(segments.unfuse_keys(list(keys.unbind(0)),
                                    dna.words_per_kmer(k)))


@pytest.mark.parametrize("k", EXTRACT_KS + [128])
def test_plain_cols_layout(k):
    """The kernel's contract: the sort's fused keys, one column a
    window, the sentinel folded in only when k % 16 != 0."""
    codes, lengths = reads_with_n(k + 1)
    jc, jv, _ = jkmer.extract_canonical_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    jc, jv = np.asarray(jc), np.asarray(jv).reshape(-1)
    W = jc.shape[-1]
    keys, valid = kmer.extract_sort_keys(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    assert keys.shape == ((W + 1) // 2, jv.size) and keys.dtype == torch.int64
    expect = jc.reshape(-1, W).copy()
    if k % 16 != 0:
        assert valid is None
        expect[~jv] = 0xFFFFFFFF
    else:
        assert np.array_equal(valid.numpy(), jv)
    assert np.array_equal(unfused(keys, k), expect)
    # the keys are segments.fused_cols of the words, bit for bit
    fused = segments.fuse_words(torch.from_numpy(expect.astype(np.int64)))
    assert torch.equal(keys, torch.stack(fused))


@pytest.mark.parametrize("k", [21, 33])
def test_plain_cols_match_pallas_interpret(k):
    """The TPU kernel itself, run through the Pallas interpreter."""
    codes, lengths = reads_with_n(k, R=16, L=100)
    cols, jv = kmer_pallas.extract_canonical_cols(
        jnp.asarray(codes), jnp.asarray(lengths), k, interpret=True)
    jv = np.asarray(jv).reshape(-1)
    keys, valid = kmer.extract_sort_keys(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    words = unfused(keys, k)
    assert valid is None
    assert np.array_equal((words != 0xFFFFFFFF).any(axis=1), jv)
    for w, col in enumerate(cols):
        assert np.array_equal(words[jv, w], np.asarray(col).reshape(-1)[jv])


@pytest.mark.parametrize("k", [22, 34, 56, 78, 128])
def test_sort_keys_match_pallas_interpret_and_jax_words(k):
    """Plain ``extract_sort_keys``, unfused, against the TPU kernel in
    the Pallas interpreter and against the JAX package's plain words, at
    the (k+1)-mer sizes of the K ladders."""
    codes, lengths = reads_with_n(k, R=16, L=150, min_len=k + 2)
    keys, valid = kmer.extract_sort_keys(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    words = unfused(keys, k)
    cols, pv = kmer_pallas.extract_canonical_cols(
        jnp.asarray(codes), jnp.asarray(lengths), k, interpret=True)
    pv = np.asarray(pv).reshape(-1)
    jc, jv, _ = jkmer.extract_canonical_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    jc, jv = np.asarray(jc).reshape(-1, words.shape[1]), \
        np.asarray(jv).reshape(-1)
    assert np.array_equal(pv, jv) and jv.any() and not jv.all()
    got_valid = (words != 0xFFFFFFFF).any(axis=1) if valid is None \
        else valid.numpy()
    assert np.array_equal(got_valid, jv)
    assert np.array_equal(words[jv], jc[jv])
    for w, col in enumerate(cols):
        assert np.array_equal(words[jv, w], np.asarray(col).reshape(-1)[jv])


def test_wrapper_uses_plain_version_on_cpu():
    codes, lengths = reads_with_n(5)
    kernel = kmer_cuda.KmerExtractKernel()
    for k in (21, 32):  # sentinel-safe, and with the validity column
        got = kernel(torch.from_numpy(codes), torch.from_numpy(lengths), k)
        ref = kmer.extract_sort_keys(torch.from_numpy(codes),
                                     torch.from_numpy(lengths), k)
        assert torch.equal(got[0], ref[0])
        assert (got[1] is None and ref[1] is None) or \
            torch.equal(got[1], ref[1])
    assert kernel.launches == 0


def test_wrapper_refuses_other_devices():
    kernel = kmer_cuda.KmerExtractKernel()
    codes = torch.zeros((2, 30), dtype=torch.uint8, device="meta")
    lengths = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernel(codes, lengths, 21)


# ---------------------------------------------------------------------------
# segments and chunking
# ---------------------------------------------------------------------------

def _rows(seed, N, W, dup=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2 ** 32, (N, W), dtype=np.uint64).astype(np.uint32)
    if dup:  # repeated rows and rows sharing a prefix
        rows[N // 2:] = rows[:N - N // 2]
        rows[::7, 0] = rows[0, 0]
    return rows


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8])
def test_sort_and_count_match_jax(W):
    rows = _rows(W, 200, W)
    valid = np.random.default_rng(W).random(200) < 0.8
    weights = np.arange(200, dtype=np.int32) % 5
    tk, tv = torch.from_numpy(rows.astype(np.int64)), torch.from_numpy(valid)
    sk, (sp,), sv = segments.sort_by_key_rows(
        tk, (torch.arange(200),), tv)
    jk, (jp,), jv = jseg.sort_by_key_rows(
        jnp.asarray(rows), (jnp.arange(200),), jnp.asarray(valid))
    assert np.array_equal(u32(sk), np.asarray(jk))
    assert np.array_equal(sp.numpy(), np.asarray(jp))  # both stable
    assert np.array_equal(sv.numpy(), np.asarray(jv))
    for w, ss in ((None, False), (None, True), (weights, False)):
        tw = None if w is None else torch.from_numpy(w)
        jw = None if w is None else jnp.asarray(w)
        u, c, n = segments.count_sorted(tk, tv, tw, sentinel_safe=ss)
        ju, jc, jn = jseg.count_sorted(jnp.asarray(rows), jnp.asarray(valid),
                                       jw, sentinel_safe=ss)
        assert int(n) == int(jn)
        assert np.array_equal(u32(u), np.asarray(ju))
        assert np.array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 6, 7, 8])
def test_unfuse_keys_inverts_fused_cols(W):
    rows = _rows(W + 40, 64, W)
    rows[0], rows[1] = 0xFFFFFFFF, 0  # the sentinel row and the least row
    t = torch.from_numpy(rows.astype(np.int64))
    fused = segments.fused_cols(list(t.unbind(1)))
    assert len(fused) == (W + 1) // 2
    assert torch.equal(segments.unfuse_keys(fused, W), t)
    assert [int(c[0]) for c in fused] == segments.fused_sentinels(W)
    # signed key order == unsigned word order
    order = segments.lexsort_perm(fused)
    assert np.array_equal(u32(t[order]),
                          rows[np.lexsort(rows.T[::-1])])


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("with_valid", [False, True])
def test_count_sorted_keys_matches_jax(W, with_valid):
    """The counter's path: fused keys in, counted words out, against the
    JAX package's count on the same rows."""
    rows = _rows(W + 20, 200, W)
    valid = np.random.default_rng(W).random(200) < 0.8
    if with_valid:  # all-ones is then a real row (k % 16 == 0)
        rows[5] = rows[6] = 0xFFFFFFFF
        valid[5] = valid[6] = True
        keyed = rows
    else:
        keyed = np.where(valid[:, None], rows, np.uint32(0xFFFFFFFF))
    keys = segments.fuse_words(torch.from_numpy(keyed.astype(np.int64)))
    u, c, n = segments.count_sorted_keys(
        keys, W, torch.from_numpy(valid) if with_valid else None)
    ju, jc, jn = jseg.count_sorted(jnp.asarray(rows), jnp.asarray(valid),
                                   None, sentinel_safe=not with_valid)
    assert int(n) == int(jn) and c.dtype == torch.int32
    assert np.array_equal(u32(u), np.asarray(ju))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    if not with_valid:
        cu, cc, cn = jseg.count_sorted_cols(
            [jnp.asarray(rows[:, w]) for w in range(W)], jnp.asarray(valid))
        assert int(n) == int(cn)
        assert np.array_equal(u32(u), np.asarray(cu))
        assert np.array_equal(c.numpy(), np.asarray(cc))


@pytest.mark.parametrize("N", [1, 7, 64, 100])
def test_searchsorted_rows_matches_jax(N):
    hay = np.unique(_rows(N, N, 3, dup=False), axis=0)
    needles = np.concatenate([hay, _rows(N + 1, 20, 3, dup=False)])
    got = segments.searchsorted_rows(
        torch.from_numpy(hay.astype(np.int64)),
        torch.from_numpy(needles.astype(np.int64)))
    ref = jseg.searchsorted_rows(jnp.asarray(hay), jnp.asarray(needles))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got[:len(hay)].numpy(), np.arange(len(hay)))


def test_compact_and_drop_scatter_match_jax():
    rng = np.random.default_rng(3)
    mask = rng.random(50) < 0.4
    vals = rng.integers(0, 100, 50).astype(np.int32)
    n, (out,) = segments.compact(torch.from_numpy(mask),
                                 torch.from_numpy(vals))
    jn, (jout,) = jseg.compact(jnp.asarray(mask), jnp.asarray(vals))
    assert int(n) == int(jn)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    idx = rng.integers(0, 11, 50)  # 10 = dropped
    got = segments.drop_scatter(10, torch.from_numpy(idx),
                                torch.from_numpy(vals), "amax")
    ref = jnp.zeros(10, jnp.int32).at[jnp.asarray(idx)].max(
        jnp.asarray(vals), mode="drop")
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_pad_to_multiple():
    x = torch.arange(10).reshape(5, 2)
    y = chunking.pad_to_multiple(x, 4, fill=7)
    assert y.shape == (8, 2) and int(y[5:].unique()) == 7
    assert torch.equal(chunking.dslice(y, 4, 4)[0], x[4])
