"""Sequence-sharded decode caches on the CPU: with fewer slots than data
ranks the reference's ``cache_specs`` splits a dense cache's positions
over ``data``; the port's data rank r then holds positions
[r S/d, (r + 1) S/d) of GQA's ``k``/``v`` and MLA's ``latent``, a
prefill writes the positions the rank holds, a chunk whose earlier
chunks sit on another rank gathers them for that call, and a decode step
attends the rank's positions (K3 or the plain path, with its
log-sum-exp) and merges the partials in f32 (``collectives.lse_combine``).

- K3's plain version returns the (B, KV, G) log-sum-exp of each head's
  scaled scores over its valid keys; its output agrees with the
  reference's ``flash_decode`` run in interpret mode (1e-5: f32 online
  softmax, the same block partition, ``tests/test_torch_flash_decode.py``'s
  tolerance) and its lse with a float64 log-sum-exp of the same scores
  (1e-5 relative: f32 sums of up to 200 exponentials); a row of no valid
  key gives lse -inf and a zero output.
- Two shards' partials merged equal the whole-sequence attention (f32,
  1e-5 absolute of outputs of order 5: the merge reweighs two f32
  partials, a few roundings), a shard holding none of a row's keys
  weighs 0 without a NaN, and a row no shard holds a key of is 0.
- A 1-slot engine at (data=2, model=1) (gloo ranks, one spawn) serves
  llama (flash decode on and off; the reference's parameters through
  numpy) and deepseek's MLA latent (its own seeded draw), prompts of
  40 and 33 tokens over a 64-deep cache (32 positions a rank), whole and
  in 24-token chunks (the second chunk crosses the shard boundary), f32:
  streams and counters equal the local runs'.  (The merge reorders the
  attention's sums: an f32 stream could part at a logit near-tie; these
  do not.)
- A ``cuda``-marked test holds the kernel's lse against its plain
  version (skipped without a card).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_data_worker as WD
import test_torch_mesh_worker as W
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.kernels import flash_ops as jfo
from repro.models import build_model
from repro_torch.distributed import spawn
from repro_torch.distributed.collectives import merge_partials
from repro_torch.kernels import flash_ops
from repro_torch.kernels.flash_attention import (
    flash_decode_ref,
    flash_decode_split_ref,
)
from repro_torch.models.layers import decode_attention
from repro_torch.models.model import Model, params_from_reference

torch.set_num_threads(1)
F32 = torch.float32


def _case(S, seed=0, B=4, KV=2, G=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    kc = (5 * rng.standard_normal((B, S, KV, D))).astype(np.float32)
    vc = (5 * rng.standard_normal((B, S, KV, D))).astype(np.float32)
    lengths = np.array([0, 1, S // 2, S], np.int32)[:B]
    return q, kc, vc, lengths


def _lse64(q, kc, lengths):
    """float64 log-sum-exp of each head's scaled scores over its valid
    keys, (B, KV, G)."""
    B, _, H, D = q.shape
    KV = kc.shape[2]
    qg = q[:, 0].reshape(B, KV, H // KV, D).astype(np.float64)
    s = np.einsum("bkgd,bskd->bkgs", qg, kc.astype(np.float64)) * D ** -0.5
    out = np.full((B, KV, H // KV), -np.inf)
    for b, n in enumerate(lengths):
        if n:
            m = s[b, ..., :n].max(-1)
            out[b] = m + np.log(np.exp(s[b, ..., :n] - m[..., None]).sum(-1))
    return out


@pytest.mark.parametrize("S", [37, 200])
def test_k3_plain_lse_matches_reference(S):
    q, kc, vc, lengths = _case(S)
    t = [torch.from_numpy(a) for a in (q, kc, vc, lengths)]
    out, chk, lse = flash_ops.flash_decode(*t, return_lse=True)
    # the reference's kernel takes rows with keys; the empty row apart
    oj, _ = jfo.flash_decode(jnp.asarray(q[1:]), jnp.asarray(kc[1:]),
                             jnp.asarray(vc[1:]), jnp.asarray(lengths[1:]))
    np.testing.assert_allclose(out[1:].numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    want = _lse64(q, kc, lengths)
    np.testing.assert_allclose(lse[1:].numpy(), want[1:], rtol=1e-5)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    assert not bool(chk.flag)
    # the split walk (what the kernel runs) merges to the same lse
    split = flash_decode_split_ref(*t[:3], None, t[3], block=16, splits=3,
                                   lse=True)[-1]
    np.testing.assert_allclose(split[1:].numpy(), want[1:], rtol=1e-5)
    # the paged wrapper through an identity table
    BS = 8
    W_ = -(-S // BS)
    pad = W_ * BS - S
    kp = np.pad(kc, ((0, 0), (0, pad), (0, 0), (0, 0))).reshape(
        -1, BS, *kc.shape[2:])
    vp = np.pad(vc, ((0, 0), (0, pad), (0, 0), (0, 0))).reshape(
        -1, BS, *vc.shape[2:])
    table = np.arange(len(q) * W_, dtype=np.int32).reshape(len(q), W_)
    _, _, lse_p = flash_ops.flash_decode_paged(
        t[0], torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), t[3], return_lse=True)
    np.testing.assert_allclose(lse_p[1:].numpy(), want[1:], rtol=1e-5)


@pytest.mark.parametrize("kernel", ["k3", "plain"])
def test_two_shards_merge_to_the_whole(kernel):
    S = 64
    q, kc, vc, lengths = _case(S, seed=3)
    lengths = np.array([0, 5, 32, 50], np.int32)
    t = [torch.from_numpy(a) for a in (q, kc, vc)]
    lens = torch.from_numpy(lengths)

    def attend(k, v, n):
        if kernel == "k3":
            o, _, lse = flash_ops.flash_decode(t[0], k, v, n, bk=16,
                                               return_lse=True)
        else:
            o, lse = decode_attention(t[0], k, v, n, return_lse=True)
        return o, lse

    whole, _ = attend(t[1], t[2], lens)
    parts = []
    for r in range(2):
        lo = r * S // 2
        n = (lens - lo).clamp(0, S // 2).to(torch.int32)
        o, lse = attend(t[1][:, lo:lo + S // 2].contiguous(),
                        t[2][:, lo:lo + S // 2].contiguous(), n)
        parts.append((o, lse.reshape(len(q), 1, -1)))
    merged = merge_partials(torch.stack([o for o, _ in parts]).to(F32),
                            torch.stack([lse for _, lse in parts]))
    assert torch.isfinite(merged).all()
    # row 1 (5 keys) and row 2 (32) lie in shard 0 alone: shard 1 weighs 0
    assert torch.isneginf(parts[1][1][:3]).all()
    if kernel == "k3":
        np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=1e-5)
    else:
        # the plain path rounds each shard's probabilities through the
        # cache dtype (f32 here): the same 1e-5
        np.testing.assert_allclose(merged[1:].numpy(), whole[1:].numpy(),
                                   atol=1e-5)
    assert not merged[0].any()


# ------------------------------------------------------ the served path
@pytest.fixture(scope="module")
def params():
    jl = build_model(jscaled(jget("llama3.2-1b"), n_layers=2))
    jp = jl.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    # the MLA stack is held to the port's own local twin, on its own
    # seeded draw (the reference's init of deepseek costs 16 s here)
    out = {"llama": params_from_reference(
               W.small_config(), jax.tree_util.tree_map(np.asarray, jp),
               dtype=F32),
           "mla": Model(W.mla_config()).init_params(2, dtype=F32)}
    # the ranks run on a thread of their own while this process runs the
    # local twins (the ``local`` fixture)
    pool = ThreadPoolExecutor(1)
    out["ranks"] = pool.submit(spawn.run, WD.seq_rank, 2, dict(out),
                               device="cpu")
    yield out
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def local(params):
    return {"llama": WD.seq_scenarios(Model(W.small_config()),
                                      params["llama"], None, flash=True),
            "llama_plain": WD.seq_scenarios(Model(W.small_config()),
                                            params["llama"], None,
                                            flash=False),
            "mla": WD.seq_scenarios(Model(W.mla_config()), params["mla"],
                                    None, flash=False)}


@pytest.fixture(scope="module")
def ranks(params, local):
    return params["ranks"].result()


@pytest.mark.parametrize("stack", ["llama", "llama_plain", "mla"])
@pytest.mark.parametrize("run", ["dense", "chunked"])
def test_one_slot_engine_equals_local(ranks, local, stack, run):
    want = local[stack][run]
    assert want["stats"]["tokens"] == 12 and not want["errors"]
    for r, rec in enumerate(ranks):
        got = {k: v for k, v in rec[stack][run].items() if k != "shard"}
        assert got == want, (r, stack, run)


def test_each_rank_holds_half_the_positions(ranks):
    for r, rec in enumerate(ranks):
        for stack in ("llama", "mla"):
            kind, lo, n, shape = rec[stack]["dense"]["shard"]
            assert (kind, lo, n) == ("seq", 32 * r, 32)
            assert shape[:2] == [1, 32]


def test_decode_merges_and_chunks_gather(ranks, local):
    """Every decode step merges each layer's partials (one LSE combine a
    layer a step), the chunked run's second chunk gathers the cells rank
    0 holds, and no FSDP or slot gather runs."""
    counts = ranks[0]["counts"]
    # one slot: each token after a request's first is one decode step
    steps = sum(local["llama"][r]["stats"]["tokens"] - 2
                for r in ("dense", "chunked"))
    assert counts["lse_combine"] == 2 * steps > 0
    assert counts["data_gather"] > 0 and counts["fsdp_gather"] == 0
    assert ranks[0]["llama"]["chunked"]["stats"]["prefill_chunks"] > 0


def test_spec_decode_over_a_sequence_shard_is_refused(params):
    """Speculation's verify merge is not ported: a sequence-sharded
    cache refuses ``spec_decode`` (checked before any rank starts)."""
    from repro_torch.models.layers import CacheSplit
    from repro_torch.serve.executor import LocalExecutor

    calls = {}
    orig = LocalExecutor.layout

    def seq(self, slots, max_len, paged):
        calls["n"] = slots
        self.cache_split = CacheSplit("seq", 0, max_len)

    LocalExecutor.layout = seq
    try:
        from repro_torch.serve.engine import ServeEngine

        with pytest.raises(NotImplementedError, match="sequence-sharded"):
            ServeEngine(Model(W.small_config()), params["llama"], slots=1,
                        max_len=64, dtype=F32, device="cpu",
                        spec_decode="ngram", draft_len=2)
    finally:
        LocalExecutor.layout = orig
    assert calls["n"] == 1


@pytest.mark.cuda
def test_k3_lse_on_the_card():
    """K3's lse output against its plain version on the card: f32 1e-5
    relative, the zero-length row -inf with a zero output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import flash_decode_kernel

    q, kc, vc, lengths = _case(200, seed=5)
    t = [torch.from_numpy(a).cuda() for a in (q, kc, vc, lengths)]
    got = flash_decode_kernel(*t[:3], None, t[3], block=16, lse=True)
    ref = flash_decode_ref(*(a.cpu() for a in t[:3]), None, t[3].cpu(),
                           block=16, lse=True)
    np.testing.assert_allclose(got[-1][1:].cpu().numpy(),
                               ref[-1][1:].numpy(), rtol=1e-5)
    assert torch.isneginf(got[-1][0]).all() and not got[0][0].any()
