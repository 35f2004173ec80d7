"""Port VQGAN training against the JAX package on the CPU, fp32, at the
tiny shapes of tests/test_vqgan_train.py (embedding_dim 8, n_codes 32,
n_hiddens 4, downsample (2, 4, 4), discriminators 8 channels / 2
layers, video (2, 4, 16, 16, 3)).

- Codebook data init and EMA update (with and without restart, with and
  without tiling), the draws replayed from the JAX key chain: buffers
  within 1e-6 absolute.
- One fused step, GAN and LPIPS (seeded VGG16) on, against
  VQGANTrainer.make_step() from the same weights, video and draws:
  every metric within 1e-5 relative; generator and discriminator
  gradients (JAX's: its Adam first moment / (1 - b1)) within 1e-4 of
  each tensor's largest (of the module's largest for a gradient that
  vanishes); updated parameters within 2 lr everywhere and within 1e-6
  where |g| stands clear of twice its tolerance (Adam's first step
  moves a weight by about lr whatever |g| is, so a gradient within
  rounding of 0 may take either sign); codes under the near-tie
  rule and the codebook buffers within 1e-5 (1 + |value|) on the rows
  whose codes agree.

LPIPS's ReLUs and max-pools are kinks: where a ReLU's input lies within
rounding of 0, or a 2x2 window's two largest inputs lie within rounding
of each other, the port's reconstruction (which rounds its convolutions
differently from XLA's) may take the other branch, which moves the
gradient reaching the reconstruction by far more than rounding (one such
window at relu1_2, 5e-6 apart at values near 15, moved the generator's
gradients to 10x their tolerance on some CPUs). The port's step replays
the branches of the JAX step itself: the compiled step sends its LPIPS's
convolution outputs to the host (jax.debug.callback, through flax's
method interception; the step's state stays bit-equal to the plain
step's), and each ReLU of the port's LPIPS keeps its input where JAX's
was > 0, each max-pool takes JAX's pick. They come from the compiled step
and not from the JAX package run op by op: the two round the
reconstruction differently (6.7e-6 apart on an AVX-512 CPU), enough to
move a window whose top two inputs lie 3.6e-6 apart near 0.53. A branch
may differ from the port's own only within 1e-4 of that input's largest
|x| (the near-tie rule of chip_smoke.KinkReplay).
"""

import contextlib
import copy
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import seeded_lpips_weights
from mebt_tpu.models import vqgan as jvq
from mebt_tpu.models.lpips import LPIPS as JaxLPIPS
from mebt_tpu.models.lpips import VGG_SLICES, VGG16Features
from mebt_tpu.models.lpips import import_lpips_params as jax_import_lpips
from mebt_tpu.train.vqgan_train import VQGANTrainer as JaxVQGANTrainer
from mebt_tpu_torch.models.lpips import LPIPS, import_lpips_params
from mebt_tpu_torch.models.vqgan import (
    Codebook, VQGANConfig, codebook_ema_update, codebook_init_from_data)
from mebt_tpu_torch.ops.vq import code_mismatches, nearest_code
from mebt_tpu_torch.train.vqgan_train import METRICS, VQGANTrainer
from mebt_tpu_torch.utils.convert import discriminator_state_dict, vqgan_state_dict

TINY = dict(embedding_dim=8, n_codes=32, n_hiddens=4, downsample=(2, 4, 4), disc_channels=8,
            disc_layers=2, gan_feat_weight=1.0, no_random_restart=False, restart_thres=0.5)
LR = 2e-3
VIDEO_SHAPE = (2, 4, 16, 16, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- codebook -------------------------------------------------------------------


def _codebooks(rng, n_codes=32, dim=8):
    """(JAX CodebookState, port Codebook) holding the same random buffers."""
    emb, z_avg = (rng.normal(size=(n_codes, dim)).astype(np.float32) for _ in range(2))
    N = rng.uniform(0.0, 2.0, size=n_codes).astype(np.float32)
    state = jvq.CodebookState(jnp.asarray(emb), jnp.asarray(N), jnp.asarray(z_avg))
    cb = Codebook(n_codes, dim)
    for name, a in (("embeddings", emb), ("N", N), ("z_avg", z_avg)):
        getattr(cb, name).copy_(torch.from_numpy(a))
    return state, cb


def _assert_buffers(cb, state, tol, rows=slice(None)):
    """|port - JAX| <= tol (1 + |JAX|), element by element."""
    for name, want in (("embeddings", state.embeddings), ("N", state.cluster_size),
                       ("z_avg", state.z_avg)):
        np.testing.assert_allclose(getattr(cb, name).numpy()[rows], np.asarray(want)[rows],
                                   rtol=tol, atol=tol, err_msg=name)


def _tile_draws(key, flat_rows, n_codes, dim):
    """The tile noise and the permutation `_tile_to_codes` and its caller
    draw from `key` (split into the noise's key and the permutation's),
    as the JAX package draws them."""
    t_rng, p_rng = jax.random.split(key)
    n_rows = flat_rows if flat_rows >= n_codes else -(-n_codes // flat_rows) * flat_rows
    noise = None
    if flat_rows < n_codes:
        noise = _t(jax.random.normal(t_rng, (n_rows, dim)))
    return noise, _t(jax.random.permutation(p_rng, n_rows))


@pytest.mark.parametrize("rows", [12, 48], ids=["tiled", "untiled"])
def test_codebook_init_from_data_matches_jax(rows):
    rng = np.random.default_rng(rows)
    state, cb = _codebooks(rng)
    z = rng.normal(size=(rows // 4, 4, 8)).astype(np.float32)
    key = jax.random.key(3)
    want = jvq.codebook_init_from_data(state, jnp.asarray(z), key)
    noise, perm = _tile_draws(key, rows, 32, 8)
    codebook_init_from_data(cb, torch.from_numpy(z), perm=perm, noise=noise)
    _assert_buffers(cb, want, 1e-6)
    assert torch.equal(cb.N, torch.ones(32))


@pytest.mark.parametrize("restart", [True, False], ids=["restart", "no_restart"])
@pytest.mark.parametrize("rows", [12, 48], ids=["tiled", "untiled"])
def test_codebook_ema_update_matches_jax(rows, restart):
    rng = np.random.default_rng(rows + restart)
    state, cb = _codebooks(rng)
    z = rng.normal(size=(rows, 8)).astype(np.float32)
    codes = rng.integers(0, 32, size=rows)
    key = jax.random.key(5)
    want = jvq.codebook_ema_update(state, jnp.asarray(z), jnp.asarray(codes, jnp.int32), key,
                                   no_random_restart=not restart, restart_thres=0.5)
    noise, perm = _tile_draws(key, rows, 32, 8)
    codebook_ema_update(cb, torch.from_numpy(z), torch.from_numpy(codes),
                        no_random_restart=not restart, restart_thres=0.5,
                        perm=perm[:32], noise=noise)
    _assert_buffers(cb, want, 1e-6)
    # the restart replaced some rows and kept the others
    used = np.asarray(want.cluster_size) >= 0.5
    assert 0 < used.sum() < 32


def test_codebook_draws_from_a_generator():
    """Without passed-in draws the init and the restart draw from the
    generator: the same seed gives the same buffers, and each initial
    row is a row of the (tiled, noisy) latents."""
    z = torch.randn(12, 8, generator=torch.Generator().manual_seed(0))
    out = []
    for _ in range(2):
        cb = Codebook(32, 8)
        g = torch.Generator().manual_seed(1)
        codebook_init_from_data(cb, z, g)
        init = cb.embeddings.clone()
        codebook_ema_update(cb, z, torch.arange(12), g, restart_thres=0.5)
        out.append((init, cb.embeddings.clone()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    gap = (out[0][0][:, None, :] - z[None]).abs().amax(-1).amin(-1)
    assert float(gap.max()) < 0.05  # noise std 0.01 / sqrt(8)


# -- one fused step against the JAX step ------------------------------------------

KINK_BAND = 1e-4  # chip_smoke.KinkReplay's band


def _jax_step_with_lpips_convs(jt, state, video):
    """The compiled JAX step on `video`, with its LPIPS's convolution
    outputs sent to the host: (new state, metrics, {(conv name, pass):
    (B, H, W, C) array}), pass 0 the frames', 1 the reconstruction's."""
    convs, calls = {}, {}

    def keep(key, x):
        convs[key] = np.asarray(x)

    def send(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, nn.Conv) and context.method_name == "__call__"
                and isinstance(context.module.parent, VGG16Features)):
            name = context.module.name
            calls[name] = calls.get(name, 0) + 1  # a pass a call, while tracing
            jax.debug.callback(functools.partial(keep, (name, calls[name] - 1)), out)
        return out

    with nn.intercept_methods(send):
        new_state, metrics = jax.jit(jt.make_step())(state, jnp.asarray(video))
    jax.effects_barrier()
    return new_state, metrics, convs


def _jax_kinks(convs):
    """The branches of the JAX step's LPIPS kinks for its two passes, in
    the order the port's LPIPS reaches them: each of its 13 ReLUs a pass,
    whether its input (the conv's output) is > 0, (B, C, H, W) bool; each
    of its four max-pools a pass, the input each 2x2 window takes, as
    F.max_pool2d's indices: (B, C, H / 2, W / 2) of h W + w into the pool
    input's (H, W) plane, the first of tied inputs, as both take it."""
    relus, picks = [], []
    for pass_ in range(2):
        for convs_of_slice in VGG_SLICES:
            for idx in convs_of_slice:
                relus.append(torch.from_numpy(convs[f"conv{idx}", pass_].transpose(0, 3, 1, 2) > 0))
        for convs_of_slice in VGG_SLICES[:-1]:  # each pool's input: relu(the slice's last conv)
            a = np.maximum(convs[f"conv{convs_of_slice[-1]}", pass_], 0)
            B, H, W, C = a.shape
            win = a.reshape(B, H // 2, 2, W // 2, 2, C).transpose(0, 5, 1, 3, 2, 4)
            k = win.reshape(B, C, H // 2, W // 2, 4).argmax(-1)
            rows = 2 * np.arange(H // 2)[:, None] + k // 2
            cols = 2 * np.arange(W // 2)[None, :] + k % 2
            picks.append(torch.from_numpy(rows * W + cols))
    return relus, picks


def _flip(report, n, gap, x):
    """Count n flipped branches, the largest `gap` from the kink over
    KINK_BAND times the input's largest |x|."""
    report["calls"] += 1
    if n:
        report["flips"] += n
        report["over"] = max(report["over"], gap / (KINK_BAND * x.detach().abs().max().item()))


@contextlib.contextmanager
def _replay_kinks(lpips, relus, picks, report):
    """The LPIPS's kinks take JAX's branches, call by call: each of its
    ReLU modules (forward hooks that return where(JAX's input > 0, input,
    0)) and F.max_pool2d (which only the LPIPS calls in the step).
    `report["relu"]` and `report["pool"]` get the number of calls, the
    number of branches that differ from the port's own and their largest
    distance from the kink (a ReLU's |input|; a pool's max less the value
    picked) over KINK_BAND times that input's largest |x|."""
    real, relu_calls, pool_calls = F.max_pool2d, iter(relus), iter(picks)
    for kind in ("relu", "pool"):
        report[kind] = dict(calls=0, flips=0, over=0.0)

    def relu(module, args, out):
        (x,) = args
        keep = next(relu_calls)
        differ = keep != (x > 0)
        gap = x.detach().abs()[differ].max().item() if bool(differ.any()) else 0.0
        _flip(report["relu"], int(differ.sum()), gap, x)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype))

    def pool(x, *args, return_indices=False, **kwargs):
        out, idx = real(x, *args, return_indices=True, **kwargs)
        pick = next(pool_calls)
        picked = x.flatten(2).gather(2, pick.flatten(2)).view_as(out)
        differ = idx != pick
        gap = (out - picked).detach()[differ].max().item() if bool(differ.any()) else 0.0
        _flip(report["pool"], int(differ.sum()), gap, x)
        return (picked, pick) if return_indices else picked

    hooks = [m.register_forward_hook(relu) for m in lpips.modules()
             if isinstance(m, torch.nn.ReLU)]
    F.max_pool2d = pool
    try:
        yield report
    finally:
        F.max_pool2d = real
        for h in hooks:
            h.remove()


def _disc_sd(jax_tree):
    return discriminator_state_dict(jax.tree.map(np.asarray, jax_tree))


@pytest.fixture(scope="module")
def step_pair():
    """The JAX step and the port's step from the same weights, video
    and draws: (JAX state after, JAX metrics, port trainer after, port
    metrics, JAX gradients from Adam's first moment, the step's codes
    (JAX, port) and latents)."""
    torch.set_num_threads(1)
    cfg = dict(TINY, discriminator_iter_start=0, perceptual_weight=4.0)
    vgg, lin = seeded_lpips_weights(0)
    jt = JaxVQGANTrainer(jvq.VQGANConfig(**cfg), lr=LR,
                         lpips_bundle=(JaxLPIPS(), jax_import_lpips(vgg, lin)), seed=0)
    video = np.random.default_rng(1).uniform(-0.5, 0.5, size=VIDEO_SHAPE).astype(np.float32)
    s0 = jax.jit(jt.init_state)(video)
    s1, jm, convs = _jax_step_with_lpips_convs(jt, s0, video)
    s1_plain, _ = jax.jit(jt.make_step())(s0, jnp.asarray(video))
    parts = lambda s: (s.gen_params, s.codebook, s.disc_params, s.gen_opt, s.disc_opt)  # noqa: E731
    bit_equal = all(bool(np.array_equal(np.asarray(a), np.asarray(b)))
                    for a, b in zip(jax.tree.leaves(parts(s1)), jax.tree.leaves(parts(s1_plain))))

    # the draws of the JAX step's key chain (vqgan_train.py step_fn)
    r_frame, r_restart, r_init = jax.random.split(jax.random.fold_in(s0.rng, 0), 3)
    M = 2 * 2 * 4 * 4  # latent rows >= n_codes: no tiling, no noise
    draws = dict(frame_idx=_t(jax.random.randint(r_frame, (2,), 0, 4)),
                 init_perm=_tile_draws(r_init, M, 32, 8)[1],
                 restart_perm=_tile_draws(r_restart, M, 32, 8)[1][:32])

    lpips = LPIPS()
    lpips.load_state_dict(import_lpips_params(
        {k: torch.from_numpy(v) for k, v in vgg.items()},
        {k: torch.from_numpy(v) for k, v in lin.items()}))
    pt = VQGANTrainer(VQGANConfig(**cfg), lr=LR, lpips=lpips, seed=0, device="cpu")
    st = pt.init_state()
    gen0 = jax.tree.map(np.asarray, s0.gen_params)
    st.vqgan.load_state_dict(vqgan_state_dict(gen0, s0.codebook), strict=True)
    st.disc_img.load_state_dict(_disc_sd(s0.disc_params["image"]), strict=True)
    st.disc_vid.load_state_dict(_disc_sd(s0.disc_params["video"]), strict=True)

    # the step's codes on both sides: its latents against the codebook
    # after the data init
    jz = jt.core.apply({"params": s0.gen_params}, jnp.asarray(video),
                       method=jvq.VQGANCore.encode_latent)
    jcodes, _, _ = jvq.codebook_quantize(
        jvq.codebook_init_from_data(s0.codebook, jz, r_init), jz)
    relus, picks = _jax_kinks(convs)
    with torch.no_grad():
        pz = st.vqgan.encode_latent(torch.from_numpy(video)).reshape(-1, 8)
        cb = copy.deepcopy(st.vqgan.codebook)
        codebook_init_from_data(cb, pz, perm=draws["init_perm"])
        pcodes = nearest_code(pz, cb.embeddings)
    with _replay_kinks(lpips, relus, picks, {}) as kinks:
        pm = pt.step(torch.from_numpy(video), draws=draws)

    mu_g, mu_d = s1.gen_opt[0].mu, s1.disc_opt[0].mu  # (1 - b1) g on Adam's first step
    grads = dict(gen=vqgan_state_dict(jax.tree.map(lambda m: np.asarray(m) / 0.5, mu_g)),
                 image=_disc_sd(jax.tree.map(lambda m: m / 0.5, mu_d["image"])),
                 video=_disc_sd(jax.tree.map(lambda m: m / 0.5, mu_d["video"])))
    return dict(s1=s1, jm=jm, pt=pt, pm=pm, grads=grads, pz=pz, embeddings=cb.embeddings,
                pcodes=pcodes, jcodes=_t(jcodes).reshape(-1), kinks=kinks,
                bit_equal=bit_equal)


def _port_modules(pt):
    st = pt.state
    return dict(gen=st.vqgan, image=st.disc_img, video=st.disc_vid)


def test_step_replays_jax_kinks_within_rounding(step_pair):
    """The port's LPIPS took the JAX step's branch at every kink of its two
    passes: each of its 26 ReLU calls (13 a pass) and each window of its
    eight max-pools (four a pass); where that differs from its own branch
    the input lies within rounding of the kink. The step that sent its
    branches is the plain step: its optimizer state is bit-equal."""
    kinks = step_pair["kinks"]
    assert step_pair["bit_equal"]
    assert kinks["relu"]["calls"] == 2 * sum(map(len, VGG_SLICES)) == 26
    assert kinks["pool"]["calls"] == 2 * (len(VGG_SLICES) - 1) == 8
    for kind in ("relu", "pool"):
        assert kinks[kind]["over"] <= 1.0, kinks


def test_step_metrics_match_jax(step_pair):
    jm, pm = step_pair["jm"], step_pair["pm"]
    assert set(pm) == set(METRICS) == set(jm)
    for k in METRICS:
        want, got = float(jm[k]), float(pm[k])
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    assert float(pm["g_loss"]) != 0 and float(pm["gan_feat_loss"]) != 0
    assert float(pm["perceptual_loss"]) > 0 and float(pm["discloss"]) > 0


def _grad_tols(want: dict) -> dict:
    """Each tensor's gradient tolerance: 1e-4 of its largest |g|, or of
    the module's largest where a tensor's gradient vanishes (under 1e-3
    of it): a bias in front of a normalisation has a gradient of exactly
    0, which fp32 gives as rounding of that module's scale."""
    G = max(float(np.abs(w.numpy()).max()) for w in want.values())
    tols = {}
    for name, w in want.items():
        scale = float(np.abs(w.numpy()).max())
        tols[name] = 1e-4 * (scale if scale > 1e-3 * G else G)
    return tols


@pytest.mark.parametrize("part", ["gen", "image", "video"])
def test_step_gradients_match_jax(step_pair, part):
    """The generator's gradients and each discriminator's: the port
    differentiates each loss by its own parameters only, so the
    discriminators' gradients are those of their own loss alone."""
    want = step_pair["grads"][part]
    tols = _grad_tols(want)
    params = dict(_port_modules(step_pair["pt"])[part].named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        err = np.abs(p.grad.numpy() - want[name].numpy()).max()
        assert err <= tols[name], (name, err, tols[name])


@pytest.mark.parametrize("part", ["gen", "image", "video"])
def test_step_updated_params_match_jax(step_pair, part):
    """Adam's first step moves a weight by lr g / (|g| + eps): by about
    lr whatever |g| is. Where |g| stands clear of twice its tolerance
    the two signs agree and so must the weights (to fp32 rounding);
    elsewhere they may differ by up to 2 lr."""
    s1 = step_pair["s1"]
    tree = dict(gen=s1.gen_params, image=s1.disc_params["image"],
                video=s1.disc_params["video"])[part]
    want = (vqgan_state_dict(jax.tree.map(np.asarray, tree)) if part == "gen"
            else _disc_sd(tree))
    grads = step_pair["grads"][part]
    tols = _grad_tols(grads)
    n_clear = 0
    for name, p in _port_modules(step_pair["pt"])[part].named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * LR + 1e-6, (name, d.max())
        clear = np.abs(grads[name].numpy()) > 2 * tols[name]
        n_clear += int(clear.sum())
        if clear.any():
            assert d[clear].max() <= 1e-6, (name, d[clear].max())
    assert n_clear > 0


def test_step_codebook_matches_jax(step_pair):
    """Codes under the near-tie rule; the EMA'd buffers on every code row
    that no differing code touches."""
    pcodes, jcodes = step_pair["pcodes"], step_pair["jcodes"]
    n, gap, over = code_mismatches(step_pair["pz"], step_pair["embeddings"], pcodes, jcodes)
    assert over <= 1, (n, gap, over)
    agree = np.ones(32, bool)
    differ = pcodes != jcodes
    agree[pcodes[differ].numpy()] = agree[jcodes[differ].numpy()] = False
    assert agree.sum() >= 24
    _assert_buffers(step_pair["pt"].state.vqgan.codebook, step_pair["s1"].codebook, 1e-5,
                    rows=agree)
    assert step_pair["pt"].state.step == 1


def test_warm_up_gate_zeroes_the_gan_terms():
    pt = VQGANTrainer(VQGANConfig(**dict(TINY, discriminator_iter_start=10_000,
                                         perceptual_weight=0.0)), lr=LR, seed=0, device="cpu")
    disc0 = [p.detach().clone() for p in pt.init_state().disc_img.parameters()]
    video = torch.from_numpy(
        np.random.default_rng(2).uniform(-0.5, 0.5, size=VIDEO_SHAPE).astype(np.float32))
    for _ in range(2):
        m = pt.step(video)
    assert float(m["g_loss"]) == 0.0 and float(m["discloss"]) == 0.0
    assert float(m["gan_feat_loss"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert float(m["perplexity"]) >= 1.0
    # zero gradients leave Adam's discriminator step at 0
    for p, p0 in zip(pt.state.disc_img.parameters(), disc0):
        assert torch.equal(p.detach(), p0)


def test_to_vqgan_encodes_and_decodes():
    pt = VQGANTrainer(VQGANConfig(**TINY), lr=LR, seed=0, device="cpu")
    pt.init_state()
    video = np.random.default_rng(2).uniform(-0.5, 0.5, size=(1, 4, 16, 16, 3))
    vq = pt.to_vqgan()
    with torch.no_grad():
        codes = vq.encode(torch.from_numpy(np.moveaxis(video, -1, 1)).float())
        recon = vq.decode(codes)
    assert codes.shape == (1, 2, 4, 4)
    assert recon.shape == (1, 3, 4, 16, 16)
    assert vq is not pt.state.vqgan
