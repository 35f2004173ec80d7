"""Shared helpers for the port's CPU tests: a JAX model and the port's
model with identical weights, carried across by the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np

from mebt_tpu.models.mebt import MeBT as JaxMeBT
from mebt_tpu.models.mebt import MeBTConfig as JaxMeBTConfig
from mebt_tpu.models.vqgan import VQGAN as JaxVQGAN
from mebt_tpu.models.vqgan import CodebookState, VQGANCore
from mebt_tpu.models.vqgan import VQGANConfig as JaxVQGANConfig
from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig
from mebt_tpu_torch.utils.convert import mebt_state_dict, vqgan_state_dict

ALL_MODES = ("latent_enc", "latent_self", "maskgit", "latent_dec", "lt2l")
STAGED_MODES = ("latent_enc", "latent_self", "latent_enc", "latent_dec", "lt2l", "latent_dec")
TINY_VQGAN = dict(n_codes=64, embedding_dim=8, n_hiddens=8, downsample=(2, 4, 4))


def build_pair(modes, n_layer, seed=0, **kw):
    """(jax model, jax params, port model) with identical weights."""
    shape = dict(vocab_size=96, block_size=40, n_head=2, n_embd=32,
                 sos_emb=8, latent_shape=(2, 4, 4))
    shape.update(kw)
    jcfg = JaxMeBTConfig(mode=tuple(modes), n_layer=n_layer, **shape)
    jmodel = JaxMeBT(jcfg)
    N = jcfg.seq_len
    z = jnp.zeros((1, N), jnp.int32)
    b = jnp.zeros((1, N), bool)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), z, b, b)["params"]
    params = jax.tree.map(np.asarray, params)
    model = MeBT(MeBTConfig(mode=tuple(modes), n_layer=n_layer, **shape))
    model.load_state_dict(mebt_state_dict(params), strict=True)
    return jmodel, params, model.eval()


def build_vqgan_pair(seed=0, **kw):
    """(jax VQGAN, port VQGAN) with identical weights."""
    cfg = dict(TINY_VQGAN, **kw)
    jcfg = JaxVQGANConfig(**cfg)
    # VQGAN.create's steps, with the init jitted (eager init is slow on CPU)
    p_rng, c_rng = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.jit(VQGANCore(jcfg).init)(p_rng, jnp.zeros((1, 4, 32, 32, 3)))["params"]
    codebook = CodebookState.create(c_rng, jcfg.n_codes, jcfg.embedding_dim)
    jv = JaxVQGAN(config=jcfg, params=params, codebook=codebook)
    params = jax.tree.map(np.asarray, params)
    tv = VQGAN(VQGANConfig(**cfg))
    tv.load_state_dict(vqgan_state_dict(params, jv.codebook), strict=True)
    return jv, tv.eval()


# -- checkpoints in the reference's key layout, from a numpy seed -------------
# (copied from tests/test_torch_ckpt.py, which belongs to the JAX package;
# `std` scales the random weights, 1.0 as there)


def ref_mebt_state_dict(cfg, rng, std=1.0):
    """Reference parameter names: transformer.py:126-140, gpt.py:198-232."""
    D, V = cfg.n_embd, cfg.vocab_size

    def normal(*shape):
        return (std * rng.normal(size=shape)).astype(np.float32)

    sd = {
        "tok_emb.weight": normal(V, D),
        "mask_emb": normal(1, 1, D),
        "sos_emb": normal(1, cfg.sos_emb, D),
        "pos_emb": normal(1, cfg.block_size, D),
        "transformer.ln_f.weight": np.ones(D, np.float32),
        "transformer.ln_f.bias": np.zeros(D, np.float32),
        "transformer.head.weight": normal(V, D),
    }
    for i in range(cfg.n_layer):
        b = f"transformer.blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{b}.{ln}.weight"] = np.ones(D, np.float32)
            sd[f"{b}.{ln}.bias"] = np.zeros(D, np.float32)
        for proj in ("query", "key", "value", "proj"):
            sd[f"{b}.attn.{proj}.weight"] = normal(D, D)
            sd[f"{b}.attn.{proj}.bias"] = np.zeros(D, np.float32)
        sd[f"{b}.mlp.0.weight"] = normal(4 * D, D)
        sd[f"{b}.mlp.0.bias"] = np.zeros(4 * D, np.float32)
        sd[f"{b}.mlp.2.weight"] = normal(D, 4 * D)
        sd[f"{b}.mlp.2.bias"] = np.zeros(D, np.float32)
    return sd


def ref_vqgan_state_dict(cfg, rng, std=1.0, prefix=""):
    """Reference parameter names: vqgan.py Encoder / Decoder / ResBlock
    and the codebook.py buffers, with a `loss.*` entry to strip."""
    import math

    n = cfg.n_hiddens
    sd = {}

    def conv(key, cin, cout, k, t="conv"):
        shape = (cout, cin, k, k, k) if t == "conv" else (cin, cout, k, k, k)
        sd[f"{key}.{t}.weight"] = (std * rng.normal(size=shape)).astype(np.float32)
        sd[f"{key}.{t}.bias"] = np.zeros(cout, np.float32)

    def norm(key, c):
        sd[f"{key}.weight"] = np.ones(c, np.float32)
        sd[f"{key}.bias"] = np.zeros(c, np.float32)

    def res(key, c):
        norm(f"{key}.norm1", c)
        conv(f"{key}.conv1", c, c, 3)
        norm(f"{key}.norm2", c)
        conv(f"{key}.conv2", c, c, 3)

    stages = max(int(math.log2(d)) for d in cfg.downsample)
    conv("encoder.conv_first", 3, n, 3)
    for i in range(stages):
        conv(f"encoder.conv_blocks.{i}.down", n * 2**i, n * 2 ** (i + 1), 4)
        res(f"encoder.conv_blocks.{i}.res", n * 2 ** (i + 1))
    top = n * 2**stages
    norm("encoder.final_block.0", top)
    norm("decoder.final_block.0", top)
    for i in range(stages):
        cin = top if i == 0 else n * 2 ** (stages - i + 1)
        cout = n * 2 ** (stages - i)
        conv(f"decoder.conv_blocks.{i}.up", cin, cout, 4, "convt")
        res(f"decoder.conv_blocks.{i}.res1", cout)
        res(f"decoder.conv_blocks.{i}.res2", cout)
    conv("decoder.conv_last", n * 2, 3, 3)
    conv("pre_vq_conv", top, cfg.embedding_dim, 1)
    conv("post_vq_conv", cfg.embedding_dim, top, 1)
    sd["codebook.embeddings"] = rng.normal(size=(cfg.n_codes, cfg.embedding_dim)).astype(
        np.float32)
    sd["codebook.N"] = np.ones(cfg.n_codes, np.float32)
    sd["codebook.z_avg"] = sd["codebook.embeddings"].copy()
    sd["loss.discriminator.weight"] = np.zeros(3, np.float32)
    return {prefix + k: v for k, v in sd.items()}


def save_lightning(path, sd, hparams):
    """A Lightning-layout checkpoint: torch tensors under `state_dict`,
    the hparams under `hyper_parameters`."""
    import torch

    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "hyper_parameters": hparams, "epoch": 0, "global_step": 0}, path)
    return str(path)


# -- LPIPS weights from a numpy seed -------------------------------------------

# torchvision vgg16 `features` conv indices and their (in, out) channels
VGG16_CONVS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256),
               12: (256, 256), 14: (256, 256), 17: (256, 512), 19: (512, 512),
               21: (512, 512), 24: (512, 512), 26: (512, 512), 28: (512, 512)}


def seeded_lpips_weights(seed=0, lin_prefix="lin{i}"):
    """(vgg16 state dict in torchvision's key layout, with its classifier
    keys as small stand-ins; the reference's lin weights) as numpy
    arrays: He-normal convolutions, small biases, positive lin weights.
    `lin_prefix` "lins.{i}" gives the other key layout."""
    rng = np.random.default_rng(seed)
    vgg = {}
    for idx, (cin, cout) in VGG16_CONVS.items():
        vgg[f"features.{idx}.weight"] = (
            rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        vgg[f"features.{idx}.bias"] = (0.01 * rng.normal(size=cout)).astype(np.float32)
    for idx in (0, 3, 6):  # classifier keys, ignored by both loaders
        vgg[f"classifier.{idx}.weight"] = np.zeros((2, 2), np.float32)
        vgg[f"classifier.{idx}.bias"] = np.zeros(2, np.float32)
    lin = {}
    for i, c in enumerate((64, 128, 256, 512, 512)):
        lin[f"{lin_prefix.format(i=i)}.model.1.weight"] = rng.uniform(
            0.0, 1.0, size=(1, c, 1, 1)).astype(np.float32)
    return vgg, lin
