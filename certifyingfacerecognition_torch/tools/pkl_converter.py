"""Official NVIDIA .pkl -> native .npz weight converter, TensorFlow-free
(a copy of certifyingfacerecognition_tpu/tools/pkl_converter.py: numpy
and pickle only; it writes the same flat .npz, key for key and array for
array, which both packages' load_params read).

A stub unpickler maps every dnnlib/tflib class of the official
StyleGAN/PGGAN snapshots to a generic stub that records its pickled
state; the variable lists are extracted from the Network states, renamed
from TF scopes to the reference's torch state-dict names, converted to
the parameter tree and saved as a flat .npz.

Layout notes: TF stores conv kernels as HWIO and dense weights as
[in, out]; the converters' torch state dict is OIHW / [out, in], and the
parameter tree is HWIO / [in, out] again.

Usage:
    python -m certifyingfacerecognition_torch.tools.pkl_converter \
        karras2019stylegan-ffhq-1024x1024.pkl stylegan_ffhq.npz \
        [resolution] [stylegan|pggan]
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Dict, List, Tuple

import numpy as np

_STUB_PREFIXES = ("dnnlib", "tflib", "networks", "training", "config",
                  "util", "tfutil", "legacy")


class _Stub:
    """Records constructor args and pickled state without executing any
    library code."""

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs
        self._state = None

    def __setstate__(self, state):
        self._state = state

    def __setitem__(self, k, v):          # EasyDict-style containers
        self.__dict__[k] = v


def _stub_class(module: str, name: str):
    return type(f"Stub_{module.replace('.', '_')}_{name}", (_Stub,), {
        "__module__": module})


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _STUB_PREFIXES:
            return _stub_class(module, name)
        return super().find_class(module, name)


def _collect_variables(obj, out: Dict[str, np.ndarray]) -> None:
    """Walk stub objects / containers, merging every Network 'variables'
    list ((name, ndarray) pairs) into one dict."""
    if isinstance(obj, _Stub):
        state = obj._state
        if isinstance(state, dict):
            for name, var in state.get("variables", []):
                out.setdefault(name, np.asarray(var))
            for comp in (state.get("components") or {}).values():
                _collect_variables(comp, out)
        return
    if isinstance(obj, dict):
        for v in obj.values():
            _collect_variables(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_variables(v, out)


def load_pkl_variables(path: str) -> Dict[str, np.ndarray]:
    """Extract {tf_var_name: ndarray} from an official snapshot pickle.
    For the usual (G, D, Gs) tuple, later entries override earlier ones, so
    Gs (the averaged generator actually used) wins."""
    with open(path, "rb") as f:
        data = _StubUnpickler(io.BufferedReader(f), encoding="latin1").load()
    tf_vars: Dict[str, np.ndarray] = {}
    objs = data if isinstance(data, (list, tuple)) else [data]
    for obj in objs:                     # later (Gs) overrides earlier (G)
        cur: Dict[str, np.ndarray] = {}
        _collect_variables(obj, cur)
        tf_vars.update(cur)
    if not tf_vars:
        raise ValueError(f"no TF variables found in {path}")
    return tf_vars


# ---------------------------------------------------------------------------
# TF scope names -> torch-style state-dict names (the converters' input)
# ---------------------------------------------------------------------------

def stylegan_tf_to_torch_names(resolution: int) -> List[Tuple[str, str]]:
    """(torch_name, tf_name) pairs for a StyleGAN-1 generator. The TF
    naming scheme: mapping 'Dense{i}/{weight,bias}', synthesis scopes
    '{res}x{res}/{Const|Conv|Conv0_up|Conv1}/...', free noises 'noise{li}',
    RGB heads 'ToRGB_lod{n}' counted down from the output resolution."""
    from ..models.stylegan import num_layers

    pairs = [("truncation.w_avg", "dlatent_avg")]
    for i in range(8):
        pairs.append((f"mapping.dense{i}.linear.weight", f"Dense{i}/weight"))
        pairs.append((f"mapping.dense{i}.wscale.bias", f"Dense{i}/bias"))
    L = num_layers(resolution)
    for li in range(L):
        res = 2 ** (li // 2 + 2)
        if li == 0:
            scope = "4x4/Const"
            pairs.append(("synthesis.layer0.first_layer", f"{scope}/const"))
        elif li == 1:
            scope = "4x4/Conv"
        elif li % 2 == 0:
            scope = f"{res}x{res}/Conv0_up"
        else:
            scope = f"{res}x{res}/Conv1"
        if li > 0:
            # Fused upscale layers (even index, res >= 128) keep the raw
            # TF-layout [3,3,in,out] parameter under `.weight`; everything
            # else is a regular OIHW torch conv under `.conv.weight`
            # (stylegan_generator_model.py:643-657).
            fused = li % 2 == 0 and res >= 128
            key = (f"synthesis.layer{li}.weight" if fused
                   else f"synthesis.layer{li}.conv.weight")
            pairs.append((key, f"{scope}/weight"))
        pairs.append((f"synthesis.layer{li}.epilogue.apply_noise.noise",
                      f"noise{li}"))
        pairs.append((f"synthesis.layer{li}.epilogue.apply_noise.weight",
                      f"{scope}/Noise/weight"))
        pairs.append((f"synthesis.layer{li}.epilogue.bias", f"{scope}/bias"))
        pairs.append((f"synthesis.layer{li}.epilogue.style_mod.dense."
                      f"linear.weight", f"{scope}/StyleMod/weight"))
        pairs.append((f"synthesis.layer{li}.epilogue.style_mod.dense."
                      f"wscale.bias", f"{scope}/StyleMod/bias"))
    n_heads = L // 2
    top_lod = n_heads - 1
    for oi in range(n_heads):
        lod = top_lod - oi
        pairs.append((f"synthesis.output{oi}.conv.weight",
                      f"ToRGB_lod{lod}/weight"))
        pairs.append((f"synthesis.output{oi}.bias", f"ToRGB_lod{lod}/bias"))
    return pairs


def tf_vars_to_torch_state_dict(tf_vars: Dict[str, np.ndarray],
                                resolution: int) -> Dict[str, np.ndarray]:
    """Rename + relayout TF variables into the torch-style state dict the
    model converters consume. TF dense [in,out] -> torch [out,in]; TF conv
    HWIO -> torch OIHW; const/noise NCHW passthrough."""
    sd: Dict[str, np.ndarray] = {}
    for torch_name, tf_name in stylegan_tf_to_torch_names(resolution):
        if tf_name not in tf_vars:
            raise KeyError(f"TF variable {tf_name} (for {torch_name}) "
                           f"missing from pickle")
        var = np.asarray(tf_vars[tf_name], np.float32)
        if "linear.weight" in torch_name:
            var = var.T                               # [in,out] -> [out,in]
        elif torch_name.endswith("conv.weight"):
            var = var.transpose(3, 2, 0, 1)           # HWIO -> OIHW
        # fused `.weight` stays in its TF [3,3,in,out] layout (that is what
        # the torch model itself stores, stylegan_generator_model.py:644).
        if torch_name == "synthesis.layer0.first_layer":
            var = var.reshape((1,) + var.shape[-3:])  # [1,C,4,4]
        if tf_name.startswith("noise"):
            # TF noises are NHWC [1,H,W,1] (or [H,W]); torch wants [1,1,H,W].
            var = np.squeeze(var)
            var = var.reshape(1, 1, var.shape[-2], var.shape[-1])
        sd[torch_name] = var
    return sd


def convert_stylegan_pkl(pkl_path: str, out_path: str,
                         resolution: int = 1024) -> None:
    from ..models import stylegan
    from ..utils import weights as W

    tf_vars = load_pkl_variables(pkl_path)
    sd = tf_vars_to_torch_state_dict(tf_vars, resolution)
    params = stylegan.convert_state_dict_np(sd, resolution)
    W.save_params(out_path, params)
    print(f"Converted {len(tf_vars)} TF variables -> {out_path}")


# ---------------------------------------------------------------------------
# PGGAN (ProgressiveGAN) snapshots
# ---------------------------------------------------------------------------

def pggan_tf_to_torch_names(resolution: int) -> List[Tuple[str, str]]:
    """(torch_name, tf_name) pairs for a PGGAN generator. TF scheme
    (pggan_generator_model.py:34-89): '4x4/Dense', '4x4/Conv', then
    '{res}x{res}/Conv{0,1}'; RGB heads 'ToRGB_lod{n}' with lod 0 at the
    native output resolution (the reference shifts its 1024-table by
    10-log2(res) at conversion time, pggan_generator.py:57-60 — here the
    names are generated directly for the target resolution)."""
    from ..models.pggan import num_layers

    pairs = [("layer0.conv.weight", "4x4/Dense/weight"),
             ("layer0.wscale.bias", "4x4/Dense/bias"),
             ("layer1.conv.weight", "4x4/Conv/weight"),
             ("layer1.wscale.bias", "4x4/Conv/bias")]
    L = num_layers(resolution)
    for li in range(2, L):
        res = 2 ** (li // 2 + 2)
        scope = f"{res}x{res}/Conv{li % 2}"
        pairs.append((f"layer{li}.conv.weight", f"{scope}/weight"))
        pairs.append((f"layer{li}.wscale.bias", f"{scope}/bias"))
    n_heads = L // 2
    for oi in range(n_heads):
        lod = n_heads - 1 - oi
        pairs.append((f"output{oi}.conv.weight", f"ToRGB_lod{lod}/weight"))
        pairs.append((f"output{oi}.wscale.bias", f"ToRGB_lod{lod}/bias"))
    return pairs


def pggan_tf_vars_to_torch_state_dict(tf_vars: Dict[str, np.ndarray],
                                      resolution: int
                                      ) -> Dict[str, np.ndarray]:
    """Rename + relayout PGGAN TF variables. The 4x4 head is a TF dense
    [512, 512*4*4] applied to the latent and reshaped NCHW; as a conv its
    torch form is the [in,out,4,4]-viewed, oi-swapped, spatially-flipped
    kernel (exactly the reference's view/permute/flip,
    pggan_generator.py:68-71). Other convs are HWIO -> OIHW."""
    sd: Dict[str, np.ndarray] = {}
    for torch_name, tf_name in pggan_tf_to_torch_names(resolution):
        if tf_name not in tf_vars:
            raise KeyError(f"TF variable {tf_name} (for {torch_name}) "
                           f"missing from pickle")
        var = np.asarray(tf_vars[tf_name], np.float32)
        if torch_name == "layer0.conv.weight":
            var = var.reshape(var.shape[0], -1, 4, 4)      # [in, out, 4, 4]
            var = var.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1].copy()
        elif torch_name.endswith("conv.weight"):
            var = var.transpose(3, 2, 0, 1)                # HWIO -> OIHW
        sd[torch_name] = var
    return sd


def convert_pggan_pkl(pkl_path: str, out_path: str,
                      resolution: int = 1024) -> None:
    from ..models import pggan
    from ..utils import weights as W

    tf_vars = load_pkl_variables(pkl_path)
    sd = pggan_tf_vars_to_torch_state_dict(tf_vars, resolution)
    params = pggan.convert_state_dict_np(sd, resolution)
    W.save_params(out_path, params)
    print(f"Converted {len(tf_vars)} TF variables -> {out_path}")


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        raise SystemExit(2)
    res = int(argv[2]) if len(argv) > 2 else 1024
    gan = argv[3] if len(argv) > 3 else (
        "pggan" if "pggan" in argv[0].lower()
        or "karras2018" in argv[0].lower() else "stylegan")
    if gan == "pggan":
        convert_pggan_pkl(argv[0], argv[1], res)
    else:
        convert_stylegan_pkl(argv[0], argv[1], res)


if __name__ == "__main__":
    main()
