"""The port's MoE layer and int8 KV cache ≡ the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through ``repro.models.moe``
and ``repro_torch.models.moe``, and through both packages' int8 cache
functions.

* ``_dispatch_indices``: ``slot`` and ``keep`` bit for bit, on uniform ids,
  on ids skewed so that capacity drops occur, and on ids all equal to one
  expert, at capacities that drop and that do not.
* ``moe_layer``: the expert ids (top-k in descending probability, ties to
  the lower id), the slots and the capacity bit for bit, and the combine
  bit for bit on identical inputs; ``y`` and ``aux``
  in float32 within ``F32_TOL`` (1e-5), in bf16 ``y`` within ``BF16_REL``
  of its largest magnitude plus ``BF16_REL`` relative
  (``tests/test_torch_models.py``'s bounds) and ``aux`` (float32 router
  arithmetic on the same bf16 inputs) within ``F32_TOL``.
* The properties of ``tests/test_moe_layer.py`` on the port: a dense
  per-token reference at ample capacity, bounded drops, a collapsed router
  with a larger balance loss than a uniform one, finite gradients.
* The int8 cache: ``_quant``, ``_cache_write`` and ``_cache_read`` bit for
  bit on identical inputs (both round half to even).  Inside a model the
  projections that feed them already differ by bf16 ulps, so there the
  cache holds ``CACHE_REL`` plus one int8 step of its scale
  (``tests/test_torch_models.py``).
* ``ServeEngine`` on llama4's REDUCED config (dense/MoE pairs, shared
  expert, int8 cache): a prefilled slot's K/V, scales and position are
  written into the batch state whole, and the batched engine returns
  each request's single-slot tokens.

Model-level comparisons (``tests/test_torch_models.py``,
``tests/test_torch_train.py``) route through ``record_jax_routing`` and
``force_port_routing``: a bf16 ulp of difference in a router's input
flips a token whose top-k probabilities nearly tie, after which that
token's hidden state (and, through attention, its successors') differs by
an expert, not by rounding.  So the JAX package's expert ids are recorded
in every MoE layer (a ``jax.debug.callback`` inside its scans), the
port's router takes them, and the port's own ids must equal them at every
token whose adjacent top-(k+1) probabilities differ by more than
``DECIDED_GAP``; the rest of the model is then held to its continuous
tolerance.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.models import moe as j_moe
from repro.models import transformer as j_tr
from repro_torch import configs as t_configs
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api as t_api
from repro_torch.models import common as t_common
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr

F32_TOL = 1e-5
BF16_REL = 2.0 ** -8
# a router decision counts as decided where every adjacent gap among the
# top k + 1 probabilities exceeds this: the two packages' hidden states
# differ by a few bf16 ulps (2^-8 relative each), which moves a router
# logit (a float32 sum of 64 such products) by up to about 1 % and a
# probability near 0.2 by a few 1e-3; the largest flip measured in the
# REDUCED models at (1, 2048) was at a gap of 0.0086
DECIDED_GAP = 2.0 ** -6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per worker (the suite's workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ routing


def record_jax_routing(monkeypatch) -> list:
    """The JAX package's expert ids, (T·k,) int32, of every MoE layer call
    in call order (a checkpointed backward records its recomputation
    after the forward's calls)."""
    calls = []
    real = j_moe._dispatch_indices

    def recorded(ids, n_experts, capacity):
        jax.debug.callback(lambda i: calls.append(np.asarray(i)), ids)
        return real(ids, n_experts, capacity)

    monkeypatch.setattr(j_moe, "_dispatch_indices", recorded)
    return calls


def moe_routers(params) -> list:
    """Each MoE layer's router weights as the layer body sees them (bf16
    after ``cast_compute``), in layer order."""
    stack = params["moe_layers" if "moe_layers" in params else "layers"]
    return [w.detach().to(torch.bfloat16) for w in stack["w_router"]]


def force_port_routing(monkeypatch, routers, source) -> list:
    """The port's router takes its expert ids from ``source(layer, n)``
    (``n`` the layer's call count so far: a decode step, or a remat
    recompute) instead of its own top-k; its weights are its own
    probabilities at those ids, renormalised.  The layer is the one whose
    router weights the call got.  ``source`` None records the port's own
    routing without forcing it.  Returns [(layer, own ids, ids taken,
    probabilities), ...]."""
    seen = []
    real = t_moe.route

    def forced(xg, w_router, top_k):
        logits, probs, own, own_p = real(xg, w_router, top_k)
        layer = next(i for i, w in enumerate(routers)
                     if torch.equal(w, w_router))
        n = sum(1 for s in seen if s[0] == layer)
        if source is None:
            seen.append((layer, own, own, probs.detach()))
            return logits, probs, own, own_p
        ids = torch.as_tensor(np.array(source(layer, n))).long().reshape(
            own.shape)
        seen.append((layer, own, ids, probs.detach()))
        top_p = torch.gather(probs, -1, ids)
        return logits, probs, ids, top_p / top_p.sum(-1, keepdim=True)

    monkeypatch.setattr(t_moe, "route", forced)
    return seen


def assert_decided_alike(seen) -> None:
    """The port's own ids equal the ids it took at every decided token."""
    for layer, own, ids, probs in seen:
        k = own.shape[-1]
        top = torch.sort(probs, -1, descending=True).values[..., :k + 1]
        decided = (top[..., :-1] - top[..., 1:]).min(-1).values > DECIDED_GAP
        assert torch.equal(own[decided], ids[decided]), layer


# ------------------------------------------------------------ dispatch


def _ids(kind, rng, t, e):
    if kind == "uniform":
        return rng.integers(0, e, t)
    if kind == "skewed":              # geometric: expert 0 overflows
        return np.minimum(rng.geometric(0.35, t) - 1, e - 1)
    return np.full(t, 3)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "one_expert"])
@pytest.mark.parametrize("capacity", [4, 16, 512])
def test_dispatch_indices_bit_for_bit(kind, capacity):
    rng = np.random.default_rng(capacity)
    e, t = 8, 256
    ids = _ids(kind, rng, t, e).astype(np.int32)
    js, jk = j_moe._dispatch_indices(jnp.asarray(ids), e, capacity)
    ts, tk = t_moe._dispatch_indices(torch.from_numpy(ids), e, capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if capacity < t // e:
        assert not tk.all()           # drops occurred
    # batched over a leading group axis: each row as alone
    both = torch.from_numpy(np.stack([ids, ids[::-1].copy()]))
    bs, bk = t_moe._dispatch_indices(both, e, capacity)
    assert torch.equal(bs[0], ts) and torch.equal(bk[0], tk)


# ------------------------------------------------------------ the layer


def _layer_inputs(rng, b, s, d, e, f, dtype, scale=0.25):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    ws = [(rng.standard_normal(sh) * scale).astype(np.float32)
          for sh in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    # the router stays float32, as declared
    j = [jnp.asarray(x, jdt), jnp.asarray(ws[0])] + [jnp.asarray(w, jdt)
                                                     for w in ws[1:]]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(ws[0])] + [
        torch.from_numpy(w).to(tdt) for w in ws[1:]]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_layer_matches_jax(dtype, capacity_factor, monkeypatch):
    rng = np.random.default_rng(3)
    b, s, d, e, f, k = 2, 64, 16, 8, 32, 2
    j_in, t_in = _layer_inputs(rng, b, s, d, e, f, dtype)
    jcalls = record_jax_routing(monkeypatch)
    jout = j_moe.moe_layer(*j_in, top_k=k, capacity_factor=capacity_factor)
    seen = []
    real = t_moe._dispatch_indices

    def recorded(ids, n_experts, capacity):
        out = real(ids, n_experts, capacity)
        seen.append((ids, capacity) + out)
        return out

    monkeypatch.setattr(t_moe, "_dispatch_indices", recorded)
    tout = t_moe.moe_layer(*t_in, top_k=k, capacity_factor=capacity_factor)
    (ids, capacity, slot, keep), = seen
    assert capacity == max(8, int(capacity_factor * k * b * s / e))
    np.testing.assert_array_equal(ids[0].numpy(), jcalls[0])
    js, jk = j_moe._dispatch_indices(jnp.asarray(jcalls[0]), e, capacity)
    np.testing.assert_array_equal(slot[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(jk))
    if capacity_factor < 1:
        assert not keep.all()
    a, y = _np(jout.y), _np(tout.y)
    assert tout.y.dtype == t_in[0].dtype and tout.aux_loss.dtype == \
        torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(y, a, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(y, a, atol=BF16_REL * np.abs(a).max(),
                                   rtol=BF16_REL)
    np.testing.assert_allclose(float(tout.aux_loss), float(jout.aux_loss),
                               rtol=F32_TOL, atol=F32_TOL)


def test_combine_is_xlas_bf16_scatter_add_bit_for_bit():
    """The combine on identical bf16 expert outputs, slots, keeps and
    weights equals the JAX package's expression (``moe.py`` combine_group:
    a where, a product, ``zeros.at[token].add``) bit for bit: XLA rounds
    after every add, and so do the port's k ordered adds."""
    rng = np.random.default_rng(11)
    tg, k, d, ec = 96, 4, 32, 64
    yb = rng.standard_normal((ec, d)).astype(np.float32)
    slot = rng.integers(0, ec, tg * k)
    keep = rng.random(tg * k) < 0.8
    w = rng.random((tg, k)).astype(np.float32)
    w = w / w.sum(-1, keepdims=True)
    yj = jnp.asarray(yb, jnp.bfloat16)
    contrib = jnp.where(jnp.asarray(keep)[:, None], yj[jnp.asarray(slot)], 0)
    contrib = contrib * jnp.asarray(w.reshape(-1))[:, None].astype(
        jnp.bfloat16)
    token = jnp.repeat(jnp.arange(tg), k)
    want = jnp.zeros((tg, d), jnp.bfloat16).at[token].add(contrib)
    got = t_moe.combine(torch.from_numpy(yb).to(torch.bfloat16)[None],
                        torch.from_numpy(slot)[None],
                        torch.from_numpy(keep)[None],
                        torch.from_numpy(w)[None])
    np.testing.assert_array_equal(_np(got[0]), _np(want))


def test_top_k_ties_keep_the_lower_expert_first():
    """Exact ties: ``jax.lax.top_k``'s order (lower id first), which
    decides the slot ranks and the balance loss's top-1 expert."""
    probs = [.1, .3, .3, .2, .3, .05]
    logits = torch.log(torch.tensor(probs))[None, None]
    w = torch.eye(6)
    _, _, top_e, _ = t_moe.route(logits, w, 3)
    _, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1), 3)
    assert top_e[0, 0].tolist() == [1, 2, 4] == np.asarray(je)[0, 0].tolist()


# --------------------------------------------- tests/test_moe_layer.py's


def _dense_reference(x, w_router, w_gate, w_up, w_down, top_k):
    """Every token through its top-k experts, no capacity, no dispatch."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt.float() @ w_router.float(), -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    g = torch.einsum("td,edf->tef", xt, w_gate)
    u = torch.einsum("td,edf->tef", xt, w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y_all = torch.einsum("tef,efd->ted", h, w_down)
    out = torch.zeros_like(xt)
    for i in range(top_k):
        sel = y_all[torch.arange(xt.shape[0]), top_e[:, i]]
        out = out + sel * top_p[:, i, None].to(x.dtype)
    return out.reshape(b, s, d)


def _params(e, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(sh) * 0.05)
                             .astype(np.float32))
            for sh in ((d, e), (e, d, f), (e, d, f), (e, f, d))]


def test_moe_matches_dense_reference_ample_capacity():
    b, s, d, e, f, k = 2, 16, 8, 4, 16, 2
    ws = _params(e, d, f)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s, d)).astype(np.float32))
    out = t_moe.moe_layer(x, *ws, top_k=k, capacity_factor=8.0)
    torch.testing.assert_close(out.y, _dense_reference(x, *ws, k),
                               atol=2e-4, rtol=2e-3)


def test_moe_capacity_drops_are_bounded():
    """Under a tight capacity some assignments drop, the output stays
    finite and every expert keeps at most its capacity."""
    b, s, d, e, f, k = 2, 32, 8, 4, 16, 2
    ws = _params(e, d, f, seed=3)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, s, d)).astype(np.float32))
    _, _, top_e, _ = t_moe.route(x.reshape(1, b * s, d), ws[0], k)
    capacity = t_moe.capacity_of(0.5, k, b * s, e)
    _, keep = t_moe._dispatch_indices(top_e.reshape(1, -1), e, capacity)
    assert not keep.all()
    kept = torch.bincount(top_e.reshape(-1)[keep[0]], minlength=e)
    assert int(kept.max()) <= capacity
    out = t_moe.moe_layer(x, *ws, top_k=k, capacity_factor=0.5)
    assert torch.isfinite(out.y).all()
    assert float(out.y.abs().mean()) > 0


def test_moe_aux_loss_decreases_with_balance():
    """A uniform router has a lower balance loss than a collapsed one."""
    b, s, d, e, f, k = 2, 64, 8, 8, 16, 1
    _, wg, wu, wd = _params(e, d, f)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, s, d)).astype(np.float32))
    wr_uniform = torch.zeros((d, e))
    wr_collapse = torch.zeros((d, e))
    wr_collapse[:, 0] = 5.0
    aux_u = t_moe.moe_layer(x, wr_uniform, wg, wu, wd, top_k=k).aux_loss
    aux_c = t_moe.moe_layer(x, wr_collapse, wg, wu, wd, top_k=k).aux_loss
    assert float(aux_u) < float(aux_c)


def test_moe_grad_flows():
    b, s, d, e, f, k = 1, 8, 8, 4, 16, 2
    wr, wg, wu, wd = _params(e, d, f)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, s, d)).astype(np.float32))
    wr.requires_grad_(True)
    wg.requires_grad_(True)
    out = t_moe.moe_layer(x, wr, wg, wu, wd, top_k=k, capacity_factor=4.0)
    (torch.sum(out.y ** 2) + out.aux_loss).backward()
    for g in (wr.grad, wg.grad):
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0


# ------------------------------------------------------------ int8 cache


def _kv(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def test_int8_cache_functions_bit_for_bit():
    rng = np.random.default_rng(21)
    B, H, S, hd = 3, 2, 10, 16
    kj, kt = _bf16_pair(_kv(rng, B, H, 1, hd, scale=3.0))
    vj, vt = _bf16_pair(_kv(rng, B, H, 1, hd))
    # a row of zeros (scale clamped to 1e-8) and one of exact halves
    # (round half to even)
    kj = kj.at[0, 0].set(0.0)
    kt[0, 0] = 0.0
    half = np.arange(-8, 8, dtype=np.float32) * (127.0 / 7.5) / 2
    kj = kj.at[1, 1, 0].set(jnp.asarray(half, jnp.bfloat16))
    kt[1, 1, 0] = torch.from_numpy(half).to(torch.bfloat16)
    for a, b in ((kj, kt), (vj, vt)):
        jq, js = j_tr._quant(a)
        tq, ts = t_tr._quant(b)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    pos = np.array([0, 4, 9], np.int32)
    jc = [jnp.zeros((B, H, S, hd), jnp.int8)] * 2 + [
        jnp.zeros((B, H, S, 1), jnp.float32)] * 2
    tc = [torch.zeros((B, H, S, hd), dtype=torch.int8) for _ in range(2)] + [
        torch.zeros((B, H, S, 1)) for _ in range(2)]
    for step in range(2):
        jc = j_tr._cache_write(*jc, kj, vj, jnp.asarray(pos + step))
        tc = t_tr._cache_write(*tc, kt, vt, torch.from_numpy(pos + step))
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(j_tr._cache_read(*jc), t_tr._cache_read(*tc)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(b), _np(a))
    # the bf16 cache: written as is, read as is
    zb = torch.zeros((B, H, S, hd), dtype=torch.bfloat16)
    out = t_tr._cache_write(zb, zb, None, None, kt, vt, torch.from_numpy(pos))
    assert out[2] is None and out[3] is None
    assert torch.equal(out[0][torch.arange(B), :, torch.from_numpy(pos)],
                       kt[:, :, 0])
    assert t_tr._cache_read(*out)[0] is out[0]


def test_int8_decode_state_and_specs():
    c = t_configs.get("llama4-maverick-400b-a17b", reduced=True)
    assert c.kv_cache_dtype == "int8"
    m = t_api.build(c)
    params = t_common.init_params(m.decls, seed=0, device="cpu")
    st = m.init_decode_state(params, 2, 16)
    spec = m.decode_state_specs(t_api.ShapeCell("d", "decode", 16, 2))
    for t, s in zip(st.cache, spec.cache):
        assert tuple(t.shape) == tuple(s.shape) and t.dtype == s.dtype
    assert st.cache.k.dtype == torch.int8
    assert st.cache.k_scale.shape == (c.n_layers, 2, c.kv_eff, 16, 1)
    # each its own tensor: the serving engine writes slots in place
    ptrs = {t.data_ptr() for t in st.cache}
    assert len(ptrs) == len(st.cache)
    bf = t_api.build(c.replace(kv_cache_dtype="bfloat16"))
    st = bf.init_decode_state(params, 2, 16)
    assert st.cache.k_scale is None and st.cache.k.dtype == torch.bfloat16


def test_prefill_into_writes_the_int8_slot_whole():
    """``ServeEngine._prefill_into`` leaves the batch state's slot equal
    to a one-slot run of the prompt in every cache tensor (int8 K/V, their
    scales, the position) and the other slots untouched."""
    c = t_configs.get("llama4-maverick-400b-a17b", reduced=True)
    m = t_api.build(c)
    params = t_common.init_params(m.decls, seed=3, device="cpu")
    eng = ServeEngine(c, params, batch_slots=3, max_seq=16, device="cpu")
    prompt = [7, 3, 9, 1]
    state = m.init_decode_state(params, 3, 16)
    state, logits = eng._prefill_into(state, 1, prompt)
    one = m.init_decode_state(params, 1, 16)
    for t in prompt:
        want, one = m.decode_fn(params, torch.tensor([t]), one)
    assert torch.equal(logits, want)
    for batch_t, one_t in zip(state.cache, one.cache):
        if batch_t.dim() == 1:                    # positions
            assert batch_t.tolist() == [0, len(prompt), 0]
            continue
        assert torch.equal(batch_t[:, 1:2], one_t)
        assert not batch_t[:, 0].any() and not batch_t[:, 2].any()
    assert state.cache.k_scale[:, 1, :, :len(prompt)].all()


def test_serve_engine_with_int8_cache_and_pairs():
    """Batched slots give each request the tokens of its run alone, so
    the prefilled slot's K/V and scales reach the batch state whole."""
    c = t_configs.get("llama4-maverick-400b-a17b", reduced=True)
    m = t_api.build(c)
    params = t_common.init_params(m.decls, seed=2, device="cpu")
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5], [11, 12]]
    single = ServeEngine(c, params, batch_slots=1, max_seq=32, device="cpu")
    outs = [single.run([Request(prompt=p, max_new=5)])[0].output
            for p in prompts]
    multi = ServeEngine(c, params, batch_slots=2, max_seq=32, device="cpu")
    done = multi.run([Request(prompt=p, max_new=5) for p in prompts])
    assert sorted(r.output for r in done) == sorted(outs)
