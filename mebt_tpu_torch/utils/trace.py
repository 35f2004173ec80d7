"""Host spans of the port on the profiler's timeline.

`span(name)` is a `torch.profiler.record_function` range while a
profiler runs on this thread, and a shared `nullcontext` otherwise: a
span costs a check (about a microsecond) with tracing off. A running
profiler is tracing on; nothing else turns it on. The ranges lie on the
profiler's clock with the device's activity and its launches, so a trace
tells what the host was doing while the device waited. A range carries
no value: counts are counts of spans, and a span's parent is the span
that holds it on the same thread.

`SPANS` names every span the port opens, each with its meaning.
"""

from __future__ import annotations

import contextlib

import torch

SPANS = (
    ("mebt::plan", "host planning of a decode: its plans, buckets and segments"),
    ("mebt::decode.maskgit", "one MaskGIT decode pass (sampler/decode.py:maskgit_sample)"),
    ("mebt::decode.bootstrap", "one bootstrap decode pass"),
    ("mebt::decode.random", "one random-order decode pass"),
    ("mebt::decode.entp", "one entropy-confidence decode pass"),
    ("mebt::decode.ar", "one position-order decode pass"),
    ("mebt::step", "one live decode step: its launches and host work"),
    ("mebt::fetch", "a device-to-host read, which waits for the device"),
    ("mebt::vqgan_decode", "the VQGAN decode of generated codes to uint8 pixels, on the device"),
    ("mebt::train_step", "one training step's launches (forward, backward, update)"),
    ("mebt::encode_codes", "the frozen VQGAN encode and nearest-code search of a video batch"),
    ("mebt::optimizer", "an optimizer update: gradient norm, clipping, AdamW"),
    ("mebt::loader_wait", "the loader's main thread waiting on its workers for a batch"),
    ("mebt::collate", "stacking a batch's items on the loader's main thread"),
    ("mebt::prepare_batch", "the trainer's host masks of a batch"),
    ("mebt::h2d", "a training batch's copy to the device, as the host sees it"),
    ("vqgan::init", "VQGAN training: the codebook's data init (the first step)"),
    ("vqgan::encoder", "VQGAN training: the encoder"),
    ("vqgan::quantize", "VQGAN training: the codebook lookup"),
    ("vqgan::decoder", "VQGAN training: the decoder"),
    ("vqgan::lpips", "VQGAN training: the perceptual loss"),
    ("vqgan::disc_gen", "VQGAN training: the discriminators' generator terms"),
    ("vqgan::gen_backward", "VQGAN training: the generator's backward"),
    ("vqgan::gen_adam", "VQGAN training: the generator's Adam update"),
    ("vqgan::ema", "VQGAN training: the codebook's EMA update"),
    ("vqgan::disc_step", "VQGAN training: the discriminators' loss, backward and update"),
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range named `name` while a profiler runs, else a shared
    null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
