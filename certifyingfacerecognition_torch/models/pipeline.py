"""The generator -> FRS pipeline and the smoothed base classifier (port of
certifyingfacerecognition_tpu/models/pipeline.py):

    w -> truncation -> synthesis -> [0,1] postprocess -> bilinear resize ->
    normalise -> FRS -> embeddings (-> exact nearest gallery identity)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch

from . import facenet, iresnet, stylegan
from ..constants import INP_RESOLS, MEAN, STD
from ..ops import distances as D
from ..ops import geometry as G
from ..ops.resize import transform_for_frs, transform_for_frs_cb
from ..utils.device import f32_exact_math, resolve_device, tree_map


def frm_apply(frs_method: str, frm_params: Dict, x: torch.Tensor, *,
              dtype=torch.float32) -> torch.Tensor:
    """The face-recognition backbone of ``frs_method``."""
    if frs_method == "insightface":
        return iresnet.apply(frm_params, x, dtype=dtype)
    return facenet.apply(frm_params, x, dtype=dtype)


def make_lat2embs(frs_method: str, resolution: int, dtype=torch.float32
                  ) -> Callable:
    """embed(gen_params, frm_params, w [B, 512]) -> [B, 512]."""
    img_size = INP_RESOLS[frs_method]
    use_cb = stylegan.cb_out_active(resolution, dtype)

    def embed(gen_params, frm_params, w):
        img = stylegan.synthesize_from_w(gen_params, w, resolution=resolution,
                                         dtype=dtype, cb_out=use_cb)
        if use_cb:
            x = transform_for_frs_cb(img, img_size, MEAN, STD)
        else:
            x = transform_for_frs(img, img_size, MEAN, STD)
        return frm_apply(frs_method, frm_params, x, dtype=dtype)

    return embed


@dataclass
class FacePipeline:
    """Bundled generator + FRS + gallery, and the smoothed base
    classifier over the perturbed latents w = z + p @ dirs: ``logits(z,
    p)`` the negative gallery distances, ``probs`` their softmax(-d /
    sqrt(512)), ``predict`` the exact argmin-distance identity. Parameters,
    directions and gallery are moved to ``device``; ``lat2embs`` and the
    predictions run under torch.inference_mode (forward only).
    ``embed_fn`` and ``logits`` stay differentiable: attacks take their
    gradient."""

    gen_params: Dict
    frm_params: Dict
    dirs: torch.Tensor                     # [k, 512] direction matrix (rows)
    frs_method: str = "insightface"
    resolution: int = 1024
    dtype: torch.dtype = torch.float32
    gallery: Optional[torch.Tensor] = None  # [N, 512] identity embeddings
    device: object = "cuda"
    embed_fn: Callable = field(init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.dtype == torch.float32:
            f32_exact_math()
        move = partial(torch.as_tensor, device=self.device)
        self.gen_params = tree_map(move, self.gen_params)
        self.frm_params = tree_map(move, self.frm_params)
        self.dirs = torch.as_tensor(self.dirs, dtype=torch.float32,
                                    device=self.device)
        if self.gallery is not None:
            self.gallery = torch.as_tensor(self.gallery, dtype=torch.float32,
                                           device=self.device)
        self.embed_fn = make_lat2embs(self.frs_method, self.resolution,
                                      self.dtype)

    def lat2embs(self, w, chunk: int = 0) -> torch.Tensor:
        """Embed latent codes [N, 512] (forward only); with ``chunk``, in
        batches of that size, the last one zero-padded, to bound device
        memory for large N."""
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            if not chunk or w.shape[0] <= chunk:
                return self.embed_fn(self.gen_params, self.frm_params, w)
            outs = []
            for s in range(0, w.shape[0], chunk):
                batch = w[s:s + chunk]
                n = batch.shape[0]
                if n < chunk:
                    batch = torch.cat([batch, batch.new_zeros(
                        (chunk - n, batch.shape[1]))])
                outs.append(self.embed_fn(self.gen_params, self.frm_params,
                                          batch)[:n])
            return torch.cat(outs)

    # ---- classifier head over the gallery ----
    def perturb_latents(self, z, p) -> torch.Tensor:
        """w = z + p @ dirs in full f32; z [512] or [B, 512], p [B, k]."""
        return torch.atleast_2d(z) + G.matmul_f32(p, self.dirs)

    def logits(self, z, p) -> torch.Tensor:
        """Negative distances to the gallery [B, N] (differentiable)."""
        embs = self.embed_fn(self.gen_params, self.frm_params,
                             self.perturb_latents(z, p)).float()
        gallery = self.gallery
        if gallery.is_inference():
            # made by lat2embs: autograd cannot save an inference tensor
            gallery = gallery.clone()
        return -D.cdist(embs, gallery, self.frs_method)

    def probs(self, z, p) -> torch.Tensor:
        return D.probs_from_dists(-self.logits(z, p))

    def predict(self, z, p) -> torch.Tensor:
        """Exact argmin-distance identity prediction [B] (forward only)."""
        with torch.inference_mode():
            embs = self.embed_fn(self.gen_params, self.frm_params,
                                 self.perturb_latents(z, p))
            return D.argmin_dist_refined(embs, self.gallery, self.frs_method)

    def predict_fn(self) -> Callable:
        """The (z, p) -> predictions closure of predict_fn_with_params."""
        fn, params = self.predict_fn_with_params()
        return partial(fn, params)

    def predict_fn_with_params(self, mesh=None, offset: int = 0
                               ) -> Tuple[Callable, Dict]:
        """(fn, params) with fn(params, z [512], p [B, k]) -> predictions
        [B] (int64 on the device). With a ``mesh`` (parallel/mesh.Mesh),
        ``gallery`` is this rank's shard of the gallery, starting at global
        row ``offset``, and fn returns global identities (collective over
        the mesh's id_group)."""
        embed_fn, method = self.embed_fn, self.frs_method
        params = {"gen": self.gen_params, "frm": self.frm_params,
                  "dirs": self.dirs, "gallery": self.gallery}
        if mesh is not None:
            from ..parallel.gallery import make_sharded_gallery_predict_fn

            return make_sharded_gallery_predict_fn(
                embed_fn, mesh.id_group, offset, method), params

        def fn(params, z, p):
            with torch.inference_mode():
                w = z[None, :] + G.matmul_f32(p, params["dirs"])
                embs = embed_fn(params["gen"], params["frm"], w)
                return D.argmin_dist_refined(embs, params["gallery"], method)

        return fn, params
