"""The model families that a configuration names by file: its
``generator`` is ``generators/<generator>.py`` and its ``frm_arch`` is
``frms/<frm_arch>.py``. Each file owns everything about its network: the
shared modules (``program.py``, ``inputs.py``, ``reference/pipeline.py``,
``flops.py``, the drivers) call through it and name no network.

A generator file provides

* ``LATENT_DIM``, and ``BOUNDARIES``: the five attribute directions'
  files in ``reference.pipeline.ATTRS`` order, under ``data/boundaries/``
  (an absolute path stays as it is);
* ``widths(resolution)``: the keys that its configuration states and that
  the reference builds;
* ``state_dict_specs(resolution)``: (name, shape, std, mean) of each
  tensor of its torch-layout state dict;
* ``synthesize(sd, latents, resolution, prec)``: the plain reference,
  [B, 3, R, R] images in [0, 1];
* ``latents(n, seed, device)``: identities in its own latent space, from
  ``inputs.LATENTS``;
* the hand-off to the program: ``to_program(sd, resolution, device)``
  gives the program's parameters from the state dict as numpy arrays,
  ``region(device, boundaries_dir)`` its region matrices of the five
  directions, ``pipeline(p, gallery=None)`` its ``FacePipeline`` over
  the built program ``p``, and ``dists_fn(p, remat=True)`` its
  differentiable gallery distances;
* ``stages(p, w)``: the staged timing of a certify batch of latents
  ``w`` (``pre``: the synthesis up to 256^2, ``synth``: the whole
  synthesis, ``embed``: the embedding; each a callable), or None where
  the family has no such split.

A face-recognition (FRM) file provides ``FRS`` (the program's
``frs_method`` names it serves), ``INPUT`` (its input size),
``EMBEDDING_DIM``, ``widths()``, ``state_dict_specs()``, the reference's
``embed(sd, x, prec)`` of normalised [B, 3, INPUT, INPUT] images, and
``to_program(sd, device)``, the program's converter.

The reference half of each file imports nothing of the program; the
program half imports the program inside its functions.
"""

from __future__ import annotations

from . import harness

DIRS = {"generator": harness.HERE / "generators",
        "frm": harness.HERE / "frms"}


def load(kind: str, name: str):
    """The family file of ``kind`` ('generator' or 'frm') named ``name``;
    a name with no file is refused with the list of the files there."""
    path = DIRS[kind] / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in DIRS[kind].glob("*.py"))
        raise ValueError(f"no {kind} family {name!r}: {DIRS[kind]} holds "
                         f"{', '.join(have) or 'no files'}")
    return harness.load_module(path)


def of(config: dict):
    """(generator, FRM) family files of a configuration."""
    return load("generator", config["generator"]), \
        load("frm", config["frm_arch"])
