"""Convert the DeepMind TF-Hub I3D (Kinetics-400) weights into the
`i3d_pretrained_400.pt` state dict that eval/i3d.py:load_i3d reads (the
port of mebt_tpu/cli/convert_tf_i3d.py; the reference's one-off
mebt/fvd/convert_tf_pretrained.py makes the same file).

`convert_tf_variables` is a pure function over a flat {tf_name:
ndarray} dict. Reading the TF-Hub module needs tensorflow_hub, which this
package does not require: the script stops with a message without it.

  python -m mebt_tpu_torch.cli.convert_tf_i3d --out i3d_pretrained_400.pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# Inception branch -> TF-Hub scope
# (RGB/inception_i3d/<Block>/<unit>/{conv_3d/{w,b}, batch_norm/{beta,
#  moving_mean,moving_variance}})
_BRANCH_NAMES = {
    "b0": "Branch_0/Conv3d_0a_1x1",
    "b1a": "Branch_1/Conv3d_0a_1x1",
    "b1b": "Branch_1/Conv3d_0b_3x3",
    "b2a": "Branch_2/Conv3d_0a_1x1",
    "b2b": "Branch_2/Conv3d_0b_3x3",
    "b3b": "Branch_3/Conv3d_0b_1x1",
}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _tf_unit(prefix: str, var: dict, key: str) -> dict:
    """One Unit3D: the TF kernel (kd, kh, kw, in, out) becomes the Conv3d
    weight (out, in, kd, kh, kw); TF's batch norms have no learned scale
    (gamma 1)."""
    w = np.asarray(var[f"{prefix}/conv_3d/w"], np.float32)
    out = {f"{key}.conv3d.weight": _t(np.transpose(w, (4, 3, 0, 1, 2)))}
    if f"{prefix}/conv_3d/b" in var:
        out[f"{key}.conv3d.bias"] = _t(var[f"{prefix}/conv_3d/b"])
    bn = f"{prefix}/batch_norm"
    if f"{bn}/beta" in var:
        c = w.shape[-1]
        out[f"{key}.bn.weight"] = torch.ones(c)
        out[f"{key}.bn.bias"] = _t(np.reshape(var[f"{bn}/beta"], c))
        out[f"{key}.bn.running_mean"] = _t(np.reshape(var[f"{bn}/moving_mean"], c))
        out[f"{key}.bn.running_var"] = _t(np.reshape(var[f"{bn}/moving_variance"], c))
    return out


def convert_tf_variables(var: dict) -> dict[str, torch.Tensor]:
    """var: the flat {tf_name: ndarray} of the TF-Hub module -> the state
    dict of eval/i3d.py:InceptionI3d(400)."""
    from mebt_tpu_torch.eval.i3d import I3D_STEM

    root = "RGB/inception_i3d"
    sd: dict = {}
    for name, kind, _ in I3D_STEM:
        if kind == "conv":
            sd.update(_tf_unit(f"{root}/{name}", var, name))
        elif kind == "mixed":
            for ours, tf in _BRANCH_NAMES.items():
                sd.update(_tf_unit(f"{root}/{name}/{tf}", var, f"{name}.{ours}"))
    sd.update(_tf_unit(f"{root}/Logits/Conv3d_0c_1x1", var, "logits"))
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hub_url", default="https://tfhub.dev/deepmind/i3d-kinetics-400/1")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    try:
        import tensorflow as tf  # noqa: F401
        import tensorflow_hub as hub
    except ImportError as e:
        raise SystemExit(
            f"tensorflow_hub unavailable ({e}). Run this converter where TF is "
            "installed, or pass the reference's i3d_pretrained_400.pt to "
            "eval.i3d.load_i3d directly."
        )

    module = hub.KerasLayer(args.hub_url)
    var = {v.name.split(":")[0]: v.numpy() for v in module.weights}
    torch.save(convert_tf_variables(var), args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
