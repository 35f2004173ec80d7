"""The port's host spans (mebt_tpu_torch/utils/trace.py) on the CPU: a
tiny staged generation with a bootstrap phase, a tiny `fit` from video
through the port's DataLoader and a VQGAN training step, each under
torch.profiler, read back from the exported Chrome trace. Each span
opens where its layer says and as often as the work gives (a pass, its
live steps, each read of the device's results; a training step's input,
copy, launches, encode and update), nests in its parent on one thread,
and is named in `SPANS`; with no profiler running `span` is one shared
null context, and tracing leaves the generated codes as they were."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mebt_tpu_torch.data.loader import DataLoader
from mebt_tpu_torch.models.mebt import MeBT, MeBTConfig
from mebt_tpu_torch.models.vqgan import VQGAN, VQGANConfig
from mebt_tpu_torch.sampler.generation import bidirect_generate
from mebt_tpu_torch.sampler.mask_schedule import bootstrap_plan, maskgit_plan
from mebt_tpu_torch.train import train_state, vqgan_train
from mebt_tpu_torch.train.trainer import MeBTTrainer
from mebt_tpu_torch.utils import trace

NAMES = {name for name, _ in trace.SPANS}
STAGED_MODES = ("latent_enc", "latent_self", "latent_enc", "latent_dec", "lt2l", "latent_dec")
TINY_VQGAN = dict(n_codes=64, embedding_dim=8, n_hiddens=8, downsample=(2, 4, 4))
N, BOOT, STEPS = 32, 6, 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _spans(prof, tmp_path) -> list[tuple[str, int, float, float]]:
    """(name, thread, start, end) of every host span in the exported
    Chrome trace, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(ev["name"], ev["tid"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
           for ev in events if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
           and "::" in ev["name"]]
    return sorted(out, key=lambda s: s[2])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parents) -> bool:
    return any(p[1] == child[1] and p[2] <= child[2] and child[3] <= p[3] for p in parents)


def _traced(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof, tmp_path)


def _models():
    cfg = MeBTConfig(vocab_size=64, block_size=40, n_head=2, n_embd=32, sos_emb=8,
                     latent_shape=(2, 4, 4), mode=STAGED_MODES, n_layer=len(STAGED_MODES))
    model = MeBT(cfg)
    model.init_random_(torch.Generator().manual_seed(7))
    vqgan = VQGAN(VQGANConfig(**TINY_VQGAN)).init_random_(torch.Generator().manual_seed(8))
    return model.eval(), vqgan.eval()


def test_span_is_one_shared_null_context_without_a_profiler():
    a, b = trace.span("mebt::step"), trace.span("mebt::fetch")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("mebt::step")
    assert isinstance(on, torch.profiler.record_function)
    assert trace.span("mebt::step") is a


def test_the_catalog_names_each_span_once_with_its_meaning():
    names = [name for name, _ in trace.SPANS]
    assert len(names) == len(set(names))
    assert all(name.startswith(("mebt::", "vqgan::")) for name in names)
    assert all(meaning and "\n" not in meaning for _, meaning in trace.SPANS)
    # the names other code reads, letter for letter
    assert train_state.ENCODE_SPAN == "mebt::encode_codes" and train_state.ENCODE_SPAN in NAMES
    assert vqgan_train.SPANS == (
        "vqgan::init", "vqgan::encoder", "vqgan::quantize", "vqgan::decoder", "vqgan::lpips",
        "vqgan::disc_gen", "vqgan::gen_backward", "vqgan::gen_adam", "vqgan::ema",
        "vqgan::disc_step")


@pytest.mark.parametrize("strategy", ["maskgit", "entp", "random", "ar"])
def test_generation_spans_each_pass_its_live_steps_and_reads(strategy, tmp_path):
    model, vqgan = _models()
    kw = dict(total_length=4, step_size=4, context_size=2, vid_n_steps=STEPS, vid_c_temp=4.0,
              top_k=8, bootstrap=BOOT, strategy=strategy)
    res, spans = _traced(lambda: bidirect_generate(model, vqgan, 3, 2, **kw), tmp_path)
    assert {s[0] for s in spans} <= NAMES
    boot = _named(spans, "mebt::decode.bootstrap")
    main = _named(spans, f"mebt::decode.{strategy}")
    assert len(boot) == 1 and len(main) == 1
    live = {"bootstrap": int(bootstrap_plan(N, BOOT).do_step.sum()),
            strategy: int(maskgit_plan(N, STEPS, "cosine", "linear",
                                       n_ctx_init=BOOT).do_step.sum())}
    steps = _named(spans, "mebt::step")
    assert len(steps) == sum(live.values())
    for name, (pass_,) in (("bootstrap", boot), (strategy, main)):
        assert sum(_inside(s, [pass_]) for s in steps) == live[name]
    staged = strategy != "ar"  # ar decodes on the dense scan
    # reads: the main pass's context counts (staged, with a context), the
    # score, the codes, the pixels
    fetches = _named(spans, "mebt::fetch")
    assert len(fetches) == 3 + staged
    assert sum(_inside(f, main) for f in fetches) == staged
    # plans: both passes' plans, and the staged passes' buckets or segments
    plans = _named(spans, "mebt::plan")
    assert len(plans) == 3 + staged
    assert sum(_inside(p, boot + main) for p in plans) == 1 + staged
    (dec,) = _named(spans, "mebt::vqgan_decode")
    assert not _inside(dec, boot + main)
    assert dec[3] <= fetches[-1][2]  # the pixels' read follows their decode
    # tracing leaves the draws and launches as they were
    again = bidirect_generate(model, vqgan, 3, 2, **kw)
    np.testing.assert_array_equal(res.code_maps, again.code_maps)
    np.testing.assert_array_equal(res.samples, again.samples)


class _Videos:
    def __init__(self, n: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = [dict(video=rng.uniform(-0.5, 0.5, size=(4, 16, 16, 3)).astype(np.float32),
                           indices=rng.permutation(N)) for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _train_config():
    return dict(
        model=dict(
            params=dict(vocab_size=64, block_size=32, n_layer=2, n_head=2, n_embd=16,
                        sos_emb=4, avg_loss=True, vtokens=False, unconditional=True,
                        mode=["latent_enc", "latent_dec"]),
            mask=dict(params=dict(schedule="linear", max_token=32, method="mlm",
                                  shape=[2, 4, 4], t_range=[0.0, 1.0], budget=32)),
        ),
        exp=dict(exact_lr=1.0e-3, ckpt_every=0),
    )


PER_STEP = ("mebt::loader_wait", "mebt::collate", "mebt::prepare_batch", "mebt::h2d",
            "mebt::train_step", "mebt::encode_codes", "mebt::optimizer")


@pytest.fixture(scope="module")
def fit_spans(tmp_path_factory):
    """The spans of a 4-step `fit` from video (one epoch of 4 batches of
    2, one loader thread), logging every 2 steps."""
    tmp = tmp_path_factory.mktemp("fit")
    torch.set_num_threads(1)
    vqgan = VQGAN(VQGANConfig(**TINY_VQGAN)).init_random_(torch.Generator().manual_seed(3))
    tr = MeBTTrainer(_train_config(), str(tmp / "run"), vqgan=vqgan.eval(), seed=0,
                     compute_dtype=torch.float32, device="cpu")
    state = tr.init_state()
    loader = DataLoader(_Videos(8), 2, shuffle=False, num_workers=1)
    state, spans = _traced(lambda: tr.fit(loader, max_steps=4, state=state, log_every=2,
                                          final_checkpoint=False), tmp)
    tr.logger.close()
    assert state.step == 4
    return spans


@pytest.mark.parametrize("name", PER_STEP)
def test_fit_opens_each_input_and_step_span_once_a_step(fit_spans, name):
    assert {s[0] for s in fit_spans} <= NAMES
    got = _named(fit_spans, name)
    assert len(got) == 4
    steps = _named(fit_spans, "mebt::train_step")
    inside = [_inside(s, steps) for s in got]
    # the encode and the update run inside a step; the input is made
    # outside, the next batch's while the device runs the step
    if name in ("mebt::encode_codes", "mebt::optimizer"):
        assert all(inside)
    elif name != "mebt::train_step":
        assert not any(inside)


def test_fit_reads_the_metrics_at_each_logged_step(fit_spans):
    fetches = _named(fit_spans, "mebt::fetch")
    steps = _named(fit_spans, "mebt::train_step")
    assert len(fetches) == 2
    assert [f[2] > steps[i][3] for f, i in zip(fetches, (1, 3))] == [True, True]


def test_a_vqgan_step_opens_its_parts_in_order(tmp_path):
    cfg = VQGANConfig(**dict(TINY_VQGAN, n_codes=32, n_hiddens=4, disc_channels=8,
                             disc_layers=2))
    pt = vqgan_train.VQGANTrainer(cfg, lr=2e-3, seed=0, device="cpu")
    pt.init_state()
    video = torch.from_numpy(
        np.random.default_rng(2).uniform(-0.5, 0.5, size=(2, 4, 16, 16, 3)).astype(np.float32))
    _, spans = _traced(lambda: pt.step(video), tmp_path)
    # no LPIPS loaded: its range stays shut
    want = [s for s in vqgan_train.SPANS if s != "vqgan::lpips"]
    assert [s[0] for s in spans] == want
