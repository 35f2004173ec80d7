"""VQGAN (stage 1) training: reconstruction, EMA codebook and two GANs
(mebt_tpu/train/vqgan_train.py; reference mebt/vqgan.py:95-210).

One `VQGANTrainer.step(video)` does, in the JAX step's order:

  step 0 only: the codebook's data init from the encoder's latents
  generator:   L1 x l1_weight + commitment + LPIPS on one random frame a
               sample (when loaded) + hinge generator terms of the image
               discriminator (on that frame) and the video discriminator,
               x adopt_weight + feature matching against the real
               features; the discriminators' parameters as they stood
               before the step     -> Adam(lr, 0.5, 0.9) on the VQGAN
  codebook:    EMA update (decay 0.99, Laplace smoothing, random restart)
               from the step's latents and codes
  discriminators: their loss on the detached reconstruction
                                    -> Adam(lr, 0.5, 0.9)

Each loss is differentiated with respect to its own parameters only
(`torch.autograd.grad`), so the generator's loss leaves no gradient on
the discriminators. Each discriminator call normalises with its own
batch's statistics (real and fake are separate calls). The nearest-code
search inside `codebook_quantize` is kernel K9 on the card, once a step.
After a step every parameter's `.grad` holds the gradient its optimizer
took. Host spans (utils/trace.py:span, names in SPANS) mark the step's
parts for a profile.

The step's random draws (the frame index of each sample, the init's and
the restart's tile noise and permutations) come from the trainer's
`torch.Generator` on the device, or are passed in (`draws=`), which the
tests use to replay the JAX key chain.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from mebt_tpu_torch.models.discriminator import (
    NLayerDiscriminator,
    NLayerDiscriminator3D,
    adopt_weight,
    hinge_d_loss,
    vanilla_d_loss,
)
from mebt_tpu_torch.models.lpips import LPIPS
from mebt_tpu_torch.models.vqgan import (
    VQGAN,
    VQGANConfig,
    codebook_ema_update,
    codebook_init_from_data,
    codebook_quantize,
)
from mebt_tpu_torch.runtime import resolve_device
from mebt_tpu_torch.utils.trace import SPANS as TRACE_SPANS, span

# the host ranges of a step, in order
SPANS = tuple(name for name, _ in TRACE_SPANS if name.startswith("vqgan::"))
METRICS = ("recon_loss", "commitment_loss", "perplexity", "g_loss", "gan_feat_loss",
           "perceptual_loss", "d_image_loss", "d_video_loss", "discloss", "loss")
DRAWS = ("frame_idx", "init_perm", "init_noise", "restart_perm", "restart_noise")


@dataclass
class VQGANTrainState:
    step: int
    vqgan: VQGAN
    disc_img: NLayerDiscriminator
    disc_vid: NLayerDiscriminator3D
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    generator: torch.Generator


class VQGANTrainer:
    def __init__(self, config: VQGANConfig, lr: float = 3e-4, lpips: LPIPS | None = None,
                 seed: int = 42, device=None):
        self.config = config
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self.lpips = None if lpips is None else lpips.to(self.device).eval()
        self.d_loss = hinge_d_loss if config.disc_loss_type == "hinge" else vanilla_d_loss
        self.state: VQGANTrainState | None = None

    def init_state(self) -> VQGANTrainState:
        """The VQGAN and both discriminators with seeded random weights
        (convolutions N(0, 1/fan_in)), fresh Adam states, step 0."""
        cfg, dev = self.config, self.device
        g = torch.Generator(dev).manual_seed(self.seed)
        with torch.device(dev):
            vqgan = VQGAN(cfg).init_random_(g)
            disc_img = NLayerDiscriminator(cfg.image_channels, cfg.disc_channels,
                                           cfg.disc_layers).init_random_(g)
            disc_vid = NLayerDiscriminator3D(cfg.image_channels, cfg.disc_channels,
                                             cfg.disc_layers).init_random_(g)
        self.state = VQGANTrainState(
            step=0, vqgan=vqgan, disc_img=disc_img, disc_vid=disc_vid,
            gen_opt=self._adam(vqgan.parameters()),
            disc_opt=self._adam([*disc_img.parameters(), *disc_vid.parameters()]),
            generator=torch.Generator(dev).manual_seed(self.seed + 1),
        )
        return self.state

    def _adam(self, params):
        return torch.optim.Adam(params, lr=self.lr, betas=(0.5, 0.9), eps=1e-8)

    # -- one fused step ---------------------------------------------------------

    def step(self, video: torch.Tensor, draws: dict | None = None) -> dict[str, torch.Tensor]:
        """One training step on `video` (B, T, H, W, C) in [-0.5, 0.5],
        in the dtype of the modules' parameters (fp32; the card check's
        plain reference moves them to float64); returns the metrics as
        0-d tensors on the device (no host sync). `draws` may hold any of
        DRAWS in place of the generator's."""
        st, cfg = self.state, self.config
        vq, disc_img, disc_vid = st.vqgan, st.disc_img, st.disc_vid
        video = video.to(self.device, vq.pre_vq_conv.conv.weight.dtype)
        B, T = video.shape[:2]
        draws = dict(draws or {})
        unknown = set(draws) - set(DRAWS)
        if unknown:
            raise ValueError(f"unknown draws {sorted(unknown)}; known: {DRAWS}")
        frame_idx = draws.get("frame_idx")
        if frame_idx is None:
            frame_idx = torch.randint(0, T, (B,), generator=st.generator, device=self.device)
        rows = torch.arange(B, device=self.device)
        frame_idx = frame_idx.to(self.device, torch.int64)

        def take_frame(v):  # (B, C, T, H, W) -> (B, C, H, W)
            return v[rows, :, frame_idx]

        real = video.permute(0, 4, 1, 2, 3)
        disc_factor = adopt_weight(st.step, cfg.discriminator_iter_start)

        if st.step == 0:
            # data-dependent codebook init (reference codebook.py:48-51)
            with span(SPANS[0]), torch.no_grad():
                codebook_init_from_data(vq.codebook, vq.encode_latent(video), st.generator,
                                        perm=draws.get("init_perm"),
                                        noise=draws.get("init_noise"))

        # ---- generator
        with span(SPANS[1]):
            z = vq.encode_latent(video)
        with span(SPANS[2]):
            codes, emb_st, aux = codebook_quantize(vq.codebook, z)
        with span(SPANS[3]):
            recon = vq.decode_latent(emb_st)
        recon_loss = torch.mean(torch.abs(recon - real)) * cfg.l1_weight
        frames, frames_recon = take_frame(real), take_frame(recon)
        perceptual = torch.zeros((), device=self.device)
        if self.lpips is not None and cfg.perceptual_weight > 0:
            with span(SPANS[4]):
                perceptual = torch.mean(self.lpips(frames, frames_recon)) * cfg.perceptual_weight
        with span(SPANS[5]):
            li_fake, feat_i_fake = disc_img(frames_recon)
            lv_fake, feat_v_fake = disc_vid(recon)
            g_loss = disc_factor * (cfg.image_gan_weight * -torch.mean(li_fake)
                                    + cfg.video_gan_weight * -torch.mean(lv_fake))
            feat_loss = torch.zeros((), device=self.device)
            feat_w = 4.0 / (3 + 1)
            for weight, disc, fake_feats, x in (
                    (cfg.image_gan_weight, disc_img, feat_i_fake, frames),
                    (cfg.video_gan_weight, disc_vid, feat_v_fake, real)):
                if weight > 0:
                    with torch.no_grad():
                        _, real_feats = disc(x)
                    for f, r in zip(fake_feats[:-1], real_feats[:-1]):
                        feat_loss = feat_loss + feat_w * torch.mean(torch.abs(f - r))
            feat_loss = disc_factor * cfg.gan_feat_weight * feat_loss
        total = recon_loss + aux["commitment_loss"] + g_loss + perceptual + feat_loss
        with span(SPANS[6]):
            gen_params = list(vq.parameters())
            for p, g in zip(gen_params, torch.autograd.grad(total, gen_params)):
                p.grad = g
        with span(SPANS[7]):
            st.gen_opt.step()

        # ---- EMA codebook update (reference codebook.py:66-89)
        with span(SPANS[8]):
            codebook_ema_update(vq.codebook, z.detach(), codes, st.generator,
                                no_random_restart=cfg.no_random_restart,
                                restart_thres=cfg.restart_thres,
                                perm=draws.get("restart_perm"), noise=draws.get("restart_noise"))

        # ---- discriminators on the detached reconstruction
        with span(SPANS[9]):
            recon_d = recon.detach()
            li_real, _ = disc_img(frames)
            li_fake, _ = disc_img(take_frame(recon_d))
            lv_real, _ = disc_vid(real)
            lv_fake, _ = disc_vid(recon_d)
            d_img = self.d_loss(li_real, li_fake)
            d_vid = self.d_loss(lv_real, lv_fake)
            d_total = disc_factor * (cfg.image_gan_weight * d_img + cfg.video_gan_weight * d_vid)
            disc_params = [*disc_img.parameters(), *disc_vid.parameters()]
            for p, g in zip(disc_params, torch.autograd.grad(d_total, disc_params)):
                p.grad = g
            st.disc_opt.step()

        st.step += 1
        metrics = dict(recon_loss=recon_loss, commitment_loss=aux["commitment_loss"],
                       perplexity=aux["perplexity"], g_loss=g_loss, gan_feat_loss=feat_loss,
                       perceptual_loss=perceptual, d_image_loss=d_img, d_video_loss=d_vid,
                       discloss=d_total, loss=total)
        return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}

    # -- export and checkpoints -------------------------------------------------

    def to_vqgan(self) -> VQGAN:
        """A copy of the trained VQGAN (weights and codebook), in eval mode."""
        return copy.deepcopy(self.state.vqgan).eval()

    def state_dict(self) -> dict:
        st = self.state
        return {"step": st.step, "vqgan": st.vqgan.state_dict(),
                "disc_img": st.disc_img.state_dict(), "disc_vid": st.disc_vid.state_dict(),
                "gen_opt": st.gen_opt.state_dict(), "disc_opt": st.disc_opt.state_dict(),
                "generator": st.generator.get_state(), "seed": self.seed}

    def load_state_dict(self, ckpt: dict) -> None:
        st = self.state
        st.vqgan.load_state_dict(ckpt["vqgan"], strict=True)
        st.disc_img.load_state_dict(ckpt["disc_img"], strict=True)
        st.disc_vid.load_state_dict(ckpt["disc_vid"], strict=True)
        st.gen_opt.load_state_dict(ckpt["gen_opt"])
        st.disc_opt.load_state_dict(ckpt["disc_opt"])
        st.generator.set_state(ckpt["generator"].cpu())
        st.step = int(ckpt["step"])
