"""ms of one certify batch in StyleGAN's synthesis up to 256^2 (the
``pre`` stage of the staged timing)."""


def read(rec):
    return rec.get("stages_ms", {}).get("pre")
