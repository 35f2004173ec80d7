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
