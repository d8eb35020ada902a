"""The kernels' envelope is the JAX package's Pallas envelope, on the CPU
against the JAX package.

* The route predicates: the port's ``kernel_supported``,
  ``fused_kernel_supported``, ``apply_route``, ``train_route`` and
  ``resolved_train_impl`` against the JAX package's ``_use_pallas_sgd``,
  ``fused_kernel_supported``, ``_use_pallas_apply`` and
  ``resolved_train_impl`` ('pallas' is the port's 'kernel') over a grid of
  topologies: widths 1-6, depths 1-4, aggregates 2-8, the four variants, the
  kernel activations and elu, with particles on both sides of the fence of
  64 weights (P = 64 and P = 65 among them).
* The plain twins of the kernels, which the kernels equal bitwise on the
  card, off the width-2 / depth-2 grid: at width 3 / depth 3 (weightwise
  P = 33, aggregating and fft with 4 aggregates P = 42, recurrent P = 52)
  and at 6 aggregates (P = 28), N = 128.  K1 against the Pallas kernel in
  interpret mode; K2, K4, K5 and K6 against the XLA chains that the JAX
  package's own tests hold its kernels to, the cheaper reference here (the
  interpret-mode kernels of K2 at P = 33 and of K5 and K6 at P = 52 take
  minutes to compile, K4's twice the XLA chain's seconds; the soup below
  holds K4 to its interpret-mode kernel); K3's plain generation against
  the JAX package's phase composition (tests/test_fused_generation.py),
  its SGD chains those above.  SGD chains
  and transforms within rtol 1e-5 / atol 1e-6 (tests/test_pallas_ww.py),
  the generation's weights within rtol 2e-5 / atol 1e-6 and its losses
  rtol 1e-4 / atol 1e-6, dead masks exact (tests/test_fused_generation.py).
* A small population-major soup of width-3 / depth-3 aggregating particles
  with ``train_impl='kernel'`` (the plain twins on the CPU) against the JAX
  package's ``train_impl='pallas'`` soup (its K4 in interpret mode) on its
  own draws: integer state exact, weights and losses as above.
* The config refusals the JAX package makes and the port used to let
  through: ``generation_impl='fused'`` beside ``train_impl`` or
  ``apply_impl`` 'kernel' (homogeneous and mixed), ``apply_impl='kernel'``
  on a non-recurrent population-major particle, and ``apply_impl='kernel'``
  in the row-major layout.

The JAX programs are compiled once per topology, in a module-scoped
fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import multisoup as jms
from srnn_tpu import soup as jsoup
from srnn_tpu.ops import popmajor as jp
from srnn_tpu.ops.pallas_generation import \
    fused_kernel_supported as j_fused_supported
from srnn_tpu.ops.pallas_ww import ww_apply_population as j_ww_apply
from srnn_tpu.ops.predicates import is_diverged, is_zero
import srnn_tpu_torch as st
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch.ops import cuda_generation as cg
from srnn_tpu_torch.ops import popmajor as pp
from srnn_tpu_torch.ops.cuda_sgd_common import (KERNEL_MAX_WEIGHTS,
                                                kernel_supported)
from tests.test_torch_soup import _jax_draws, _port_config, _port_state

TOL = dict(rtol=1e-5, atol=1e-6)
GEN_TOL = dict(rtol=2e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
N, EPOCHS, SEVERITY, LR, EPS = 128, 2, 1, 0.01, 1e-4
VARIANTS = ("weightwise", "aggregating", "fft", "recurrent")
ACTIVATIONS = ("linear", "sigmoid", "tanh", "relu", "elu")
MODES = ("sequential", "full_batch")
#: JAX 'pallas' / 'xla' -> the port's routes
PORT_NAMES = {"pallas": {"kernel"}, "xla": {"plain", "autograd"}}


def _jt(topo) -> JTopology:
    return JTopology(**dataclasses.asdict(topo))


def _grid(variant, activation):
    aggregates = range(2, 9) if variant in ("aggregating", "fft") else (4,)
    for width in range(1, 7):
        for depth in range(1, 5):
            for k in aggregates:
                yield st.Topology(variant, width=width, depth=depth,
                                  aggregates=k, activation=activation)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_envelope_is_jax_pallas_envelope(variant, activation):
    sizes = set()
    for topo in _grid(variant, activation):
        jt = _jt(topo)
        p = topo.num_weights
        sizes.add(p)
        inside = jp._use_pallas_sgd(jt, "sequential", "pallas")
        assert kernel_supported(topo) == inside, (topo, p)
        assert inside == (activation != "elu" and p <= KERNEL_MAX_WEIGHTS)
        for mode in MODES:
            ref = jp.resolved_train_impl(jt, mode, "pallas")
            route = pp.resolved_train_impl(topo, mode, "plain")
            assert route in PORT_NAMES[ref], (topo, mode, route, ref)
            assert (pp.train_route(topo, mode) == "kernel") == (
                ref == "pallas")
            if ref == "pallas":
                assert pp.resolved_train_impl(topo, mode, "kernel") == \
                    "kernel"
            else:
                with pytest.raises(ValueError, match="train_impl='plain'"):
                    pp.resolved_train_impl(topo, mode, "kernel")
            assert cg.fused_kernel_supported(topo, mode) == \
                j_fused_supported(jt, mode), (topo, mode)
        for target in (None, 14, 64, 65):
            assert (pp.apply_route(topo, target) == "kernel") == \
                jp._use_pallas_apply(jt, "pallas", target_p=target), \
                (topo, target)
    # the grid straddles the fence
    assert min(sizes) < KERNEL_MAX_WEIGHTS < max(sizes)
    if variant == "aggregating":
        assert {64, 65} <= sizes


def test_shuffler_fence():
    """The random shuffler leaves the fused generation (its attack takes
    no permutation), not the SGD chains, as in the JAX package."""
    topo = st.Topology("aggregating", width=3, depth=3, shuffler="random")
    assert kernel_supported(topo)
    assert jp._use_pallas_sgd(_jt(topo), "sequential", "pallas")
    assert not cg.fused_kernel_supported(topo, "sequential")
    assert not j_fused_supported(_jt(topo), "sequential")


@pytest.mark.parametrize("generation_impl,field", [
    ("phases", "train_impl"), ("fused", "generation_impl")])
def test_fence_at_64(generation_impl, field):
    """P = 64 (aggregating, width 4, depth 1, 8 aggregates) takes the
    kernels and the fused generation; P = 65 (width 5, depth 2, 4
    aggregates) is refused upfront by the port and the JAX package alike,
    naming P."""
    at = st.Topology("aggregating", width=4, depth=1, aggregates=8)
    past = st.Topology("aggregating", width=5, depth=2, aggregates=4)
    assert (at.num_weights, past.num_weights) == (64, 65)
    impl = dict(generation_impl=generation_impl)
    if field == "train_impl":
        impl["train_impl"] = "kernel"
    for topo, ok in ((at, True), (past, False)):
        cfg = st.SoupConfig(topo=topo, size=4, train=1, layout="popmajor",
                            **impl)
        state = st.seed(cfg._replace(train_impl="plain",
                                     generation_impl="phases"), 0,
                        device="cpu")
        jcfg = jsoup.SoupConfig(
            topo=_jt(topo), size=4, train=1, layout="popmajor",
            generation_impl=generation_impl,
            train_impl="pallas" if field == "train_impl" else "xla")
        if ok:
            assert int(st.evolve_step(cfg, state)[0].time) == 1
            continue
        with pytest.raises(ValueError, match=f"{field}.*P=65"):
            st.evolve_step(cfg, state)
        with pytest.raises(ValueError, match=f"{field}.*P=65"):
            jsoup.evolve_step(jcfg, _jax_state(topo, 4))


def test_builds_per_topology():
    """The width-2 / depth-2 / 4-aggregate topologies launch the default
    builds (every activation and reduce kind in one library per source,
    named as before); any other topology a build of its own, its topology
    in ``-D`` flags and in the library's name, an fft topology with its
    DFT table generated from ``kvec_tables``."""
    from srnn_tpu_torch.ops import _build
    from srnn_tpu_torch.ops.cuda_kvec_train import kvec_build
    from srnn_tpu_torch.ops.cuda_sgd_common import kernel_build

    for topo in (st.Topology("weightwise", activation="tanh"),
                 st.Topology("recurrent"), st.Topology("fft",
                                                       fft_mode="rfft")):
        b = kvec_build(topo) if topo.variant == "fft" else kernel_build(topo)
        assert b == _build.DEFAULT
    assert _build.library_path("ww_train").name == \
        f"ww_train-{_build._digest()}.so"
    rnn = st.Topology("recurrent")
    assert kernel_build(rnn, t_len=17) == _build.DEFAULT
    assert kernel_build(rnn, t_len=33) == _build.Build(
        "w2d2t33-linear", (("SRNN_W", 2), ("SRNN_D", 2), ("SRNN_ACT", 0),
                           ("SRNN_T", 33)))
    ww = kernel_build(TWIN_TOPOS["ww-w3d3"])
    assert (ww.tag, ww.headers) == ("w3d3-linear", ())
    assert dict(ww.defines) == {"SRNN_W": 3, "SRNN_D": 3, "SRNN_ACT": 0}
    agg = kvec_build(TWIN_TOPOS["agg-k6"])
    assert agg.tag == "w2d2k6-linear-average" and not agg.headers
    assert dict(agg.defines)["SRNN_K"] == 6
    fft = kvec_build(TWIN_TOPOS["fft-w3d3"])
    assert fft.tag == "w3d3k4-linear-fft"
    assert dict(fft.defines)["SRNN_DFT_TABLE"] == 1
    (name, text), = fft.headers
    assert name == "srnn_dft_table.cuh"
    assert "struct DftTable<42, 4, DFT>" in text
    paths = {_build.library_path("ww_train", b).name for b in (
        _build.DEFAULT, ww, kernel_build(dataclasses.replace(
            TWIN_TOPOS["ww-w3d3"], activation="tanh")))}
    assert len(paths) == 3 and any("-w3d3-linear-" in p for p in paths)
    jobs = cg.builds_for(TWIN_TOPOS["rnn-w3d3"], (33,))
    assert [j[0] for j in jobs] == ["rnn_train", "generation_rnn",
                                    "rnn_apply"]
    assert jobs[-1][1].tag == "w3d3t33-sigmoid"


# ----------------------------------------------------- plain twins vs JAX

#: the twins' topologies off the width-2 / depth-2 grid; the recurrent one
#: sigmoid, whose slope damps rounding noise along its 52-step chains
TWIN_TOPOS = {
    "ww-w3d3": st.Topology("weightwise", width=3, depth=3),
    "agg-w3d3": st.Topology("aggregating", width=3, depth=3),
    "fft-w3d3": st.Topology("fft", width=3, depth=3),
    "rnn-w3d3": st.Topology("recurrent", width=3, depth=3,
                            activation="sigmoid"),
    "agg-k6": st.Topology("aggregating", aggregates=6),
}


def _pop(topo, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((topo.num_weights, N)) * scale).astype(
        np.float32)


def _operands(topo):
    """The generation's operands, as tests/test_fused_generation.py makes
    them: every third lane attacked, learn targets striding over the
    population (some of them attacked), lanes 0 and 1 made zero and
    divergent (both respawned from the fresh column for linear
    particles)."""
    w = _pop(topo, 1)
    w[:, 0] = 0.0
    w[3, 1] = np.inf
    idx = np.arange(N)
    att = np.where(idx % 3 == 0, (idx * 7) % N, -1)
    has = att >= 0
    has[:2] = False
    gate = (idx % 4) == 1
    gate[:2] = False
    tgt = (idx * 3) % N
    oa = att[tgt]
    return dict(w=w, fresh=_pop(topo, 2), att=np.clip(att, 0, None), has=has,
                gate=gate, tgt=tgt, oa=np.clip(oa, 0, None), oa_has=oa >= 0)


def _phase_chain(topo):
    """The JAX package's phase composition of one generation (XLA: its
    attack, its learn chain of ``SEVERITY`` epochs and train chain of
    ``EPOCHS``), returning the result and every chain's inputs and
    outputs, compiled as one program."""
    jt = _jt(topo)

    def chain(o):
        wT = o["w"]
        # both attacks in one call: the attacked lanes and the learners'
        # targets
        att = jp.apply_popmajor(
            jt, jnp.concatenate([wT[:, o["att"]], wT[:, o["oa"]]], 1),
            jnp.concatenate([wT, wT[:, o["tgt"]]], 1))
        attacked = jnp.where(o["has"][None, :], att[:, :N], wT)
        post = jnp.where(o["oa_has"][None, :], att[:, N:], wT[:, o["tgt"]])
        learned, learn_loss = jp.learn_epochs_popmajor(jt, attacked, post,
                                                       SEVERITY, LR)
        before = jnp.where(o["gate"][None, :], learned, attacked)
        trained, loss = jp.train_epochs_popmajor(jt, before, EPOCHS, LR)
        div = is_diverged(trained, axis=0)
        zero = is_zero(trained, EPS, axis=0) & ~div
        out = jnp.where((div | zero)[None, :], o["fresh"], trained)
        return dict(att=att, attacked=attacked, post=post, learned=learned,
                    learn_loss=learn_loss, before=before, trained=trained,
                    loss=loss, out=out, div=div, zero=zero)

    return jax.jit(chain)


@pytest.fixture(scope="module")
def jax_refs():
    """Per twin topology: the generation's operands and the JAX phase
    composition's chains; K1 at 2 steps for the weightwise particle."""
    refs = {}
    for name, topo in TWIN_TOPOS.items():
        o = _operands(topo)
        r = {k: np.asarray(v) for k, v in _phase_chain(topo)(
            {k: jnp.asarray(v) for k, v in o.items()}).items()}
        r["operands"] = o
        if topo.variant == "weightwise":
            r["k1"] = np.asarray(j_ww_apply(_jt(topo), jnp.asarray(r["post"]),
                                            steps=2, interpret=True))
        refs[name] = r
    return refs


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


@pytest.mark.parametrize("name", list(TWIN_TOPOS))
def test_sgd_twins_match_jax(jax_refs, name):
    """K2 / K4 / K5's plain twins (the wrappers' CPU route), train and
    learn, on the inputs the JAX chains had."""
    topo, r = TWIN_TOPOS[name], jax_refs[name]
    got = pp.learn_epochs_popmajor(topo, _t(r["attacked"]), _t(r["post"]),
                                   SEVERITY, LR)
    _close(got[0], r["learned"])
    _close(got[1], r["learn_loss"])
    got = pp.train_epochs_popmajor(topo, _t(r["before"]), EPOCHS, LR)
    _close(got[0], r["trained"])
    _close(got[1], r["loss"])


@pytest.mark.parametrize("name", list(TWIN_TOPOS))
def test_attack_twins_match_jax(jax_refs, name):
    """The attack (K6's plain twin for the recurrent attacker, the plain
    transforms of K3's other bodies) and K1's plain chain."""
    topo, r = TWIN_TOPOS[name], jax_refs[name]
    o = r["operands"]
    w = o["w"]
    assert pp.apply_route(topo) == ("kernel" if topo.variant == "recurrent"
                                    else "plain")
    got = pp.apply_popmajor(
        topo, _t(np.concatenate([w[:, o["att"]], w[:, o["oa"]]], 1)),
        _t(np.concatenate([w, w[:, o["tgt"]]], 1)))
    _close(got, r["att"])
    if topo.variant == "weightwise":
        from srnn_tpu_torch.ops.cuda_ww import ww_apply_population

        _close(ww_apply_population(topo, _t(r["post"]), 2), r["k1"])


@pytest.mark.parametrize("name", list(TWIN_TOPOS))
def test_generation_twin_matches_jax(jax_refs, name):
    """K3's plain generation (the wrapper's CPU route) against the JAX
    package's phase composition."""
    topo, r = TWIN_TOPOS[name], jax_refs[name]
    o = {k: _t(v) for k, v in r["operands"].items()}
    wT = o["w"]
    out, loss, div, zero = cg.generation_popmajor(
        topo, wT, o["fresh"], wT[:, o["att"]].contiguous(), o["has"],
        wT[:, o["tgt"]].contiguous(), wT[:, o["oa"]].contiguous(),
        o["oa_has"], o["gate"], severity=SEVERITY, train=EPOCHS, lr=LR,
        remove_divergent=True, remove_zero=True, epsilon=EPS)
    np.testing.assert_array_equal(div.numpy(), r["div"])
    np.testing.assert_array_equal(zero.numpy(), r["zero"])
    assert bool(div[1])
    assert bool(zero[0]) == (topo.activation == "linear")
    _close(out, r["out"], GEN_TOL)
    _close(loss, r["loss"], LOSS_TOL)


# ------------------------------------------------------------ the soup

SOUP_GENERATIONS = 2
SOUP_JCFG = jsoup.SoupConfig(
    topo=JTopology("aggregating", width=3, depth=3), size=32,
    attacking_rate=0.3, learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True, layout="popmajor",
    train_impl="pallas")


def test_kernel_soup_matches_jax_pallas_soup():
    """The width-3 / depth-3 aggregating soup with train_impl='kernel'
    against the JAX package's 'pallas' soup, generation by generation on
    its draws."""
    n, p = SOUP_JCFG.size, SOUP_JCFG.topo.num_weights
    w = np.random.default_rng(7).standard_normal((n, p)) * 0.3
    s = jsoup.SoupState(weights=jnp.asarray(w, jnp.float32),
                        uids=jnp.arange(n, dtype=jnp.int32),
                        next_uid=jnp.int32(n), time=jnp.int32(0),
                        key=jax.random.key(7))
    cfg = _port_config(SOUP_JCFG)
    assert cfg.train_impl == "kernel"
    state = _port_state(s)
    for g in range(SOUP_GENERATIONS):
        after, jev = jsoup.evolve_step(SOUP_JCFG, s)
        state, ev = st.evolve_step(cfg, state, _jax_draws(SOUP_JCFG, s.key))
        for field in ("uids", "next_uid", "time"):
            np.testing.assert_array_equal(
                getattr(state, field).numpy(),
                np.asarray(getattr(after, field)), err_msg=f"{g} {field}")
        np.testing.assert_array_equal(ev.action.numpy(),
                                      np.asarray(jev.action))
        np.testing.assert_array_equal(ev.counterpart.numpy(),
                                      np.asarray(jev.counterpart))
        _close(state.weights, after.weights, GEN_TOL)
        _close(ev.loss, jev.loss, LOSS_TOL)
        s = after


# ------------------------------------------------------------ refusals


def _jax_state(topo, n):
    """A JAX SoupState of ``n`` zero particles (what a refusal sees)."""
    return jsoup.SoupState(
        weights=jnp.zeros((n, topo.num_weights), jnp.float32),
        uids=jnp.arange(n, dtype=jnp.int32), next_uid=jnp.int32(n),
        time=jnp.int32(0), key=jax.random.key(0))


MIXED = (st.Topology("weightwise"), st.Topology("aggregating"),
         st.Topology("recurrent"))


@pytest.mark.parametrize("topos,layout,impl,match", [
    ((st.Topology("recurrent"),), "popmajor",
     dict(generation_impl="fused", train_impl="kernel"), "already fuses"),
    ((st.Topology("recurrent"),), "popmajor",
     dict(generation_impl="fused", apply_impl="kernel"), "already fuses"),
    (MIXED, "popmajor", dict(generation_impl="fused", train_impl="kernel"),
     "already fuses"),
    (MIXED, "popmajor", dict(generation_impl="fused", apply_impl="kernel"),
     "already fuses"),
    ((st.Topology("weightwise"),), "popmajor", dict(apply_impl="kernel"),
     "RECURRENT"),
    ((st.Topology("aggregating", width=3, depth=3),), "popmajor",
     dict(apply_impl="kernel"), "RECURRENT"),
    ((st.Topology("weightwise"),), "rowmajor", dict(apply_impl="kernel"),
     "apply_impl='(kernel|pallas)' is the popmajor lane kernel"),
    ((st.Topology("recurrent"),), "rowmajor", dict(apply_impl="kernel"),
     "apply_impl='(kernel|pallas)' is the popmajor lane kernel")],
    ids=["fused-train", "fused-apply", "mixed-fused-train",
         "mixed-fused-apply", "apply-weightwise", "apply-aggregating",
         "rowmajor-apply-weightwise", "rowmajor-apply-recurrent"])
def test_refusals_match_jax(topos, layout, impl, match):
    """Where the JAX package's evolve_step / evolve_multi_step refuses a
    config upfront, the port refuses it too; its 'plain' spelling runs."""
    jimpl = {k: ("pallas" if v == "kernel" else v) for k, v in impl.items()}
    plain = {k: ("plain" if v == "kernel" else v) for k, v in impl.items()}
    if len(topos) == 1:
        topo = topos[0]
        jcfg = jsoup.SoupConfig(topo=_jt(topo), size=4, train=1,
                                layout=layout, **jimpl)
        with pytest.raises(ValueError, match=match):
            jsoup.evolve_step(jcfg, _jax_state(topo, 4))
        cfg = st.SoupConfig(topo=topo, size=4, train=1, layout=layout, **impl)
        state = st.seed(cfg._replace(**plain), 0, device="cpu")
        with pytest.raises(ValueError, match=match):
            st.evolve_step(cfg, state)
        assert int(st.evolve(cfg._replace(**plain), state, 1).time) == 1
        return
    sizes = (3,) * len(topos)
    jcfg = jms.MultiSoupConfig(topos=tuple(_jt(t) for t in topos),
                               sizes=sizes, train=1, layout=layout, **jimpl)
    jstate = jms.MultiSoupState(
        weights=tuple(jnp.zeros((k, t.num_weights), jnp.float32)
                      for k, t in zip(sizes, topos)),
        uids=tuple(jnp.arange(k, dtype=jnp.int32) for k in sizes),
        next_uid=jnp.int32(sum(sizes)), time=jnp.int32(0),
        key=jax.random.key(0))
    with pytest.raises(ValueError, match=match):
        jms.evolve_multi_step(jcfg, jstate)
    cfg = ms.MultiSoupConfig(topos=topos, sizes=sizes, train=1,
                             layout=layout, **impl)
    state = ms.seed_multi(cfg._replace(**plain), 0, device="cpu")
    with pytest.raises(ValueError, match=match):
        ms.evolve_multi_step(cfg, state)
    assert int(ms.evolve_multi(cfg._replace(**plain), state, 1).time) == 1
