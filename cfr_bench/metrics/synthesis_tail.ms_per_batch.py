"""ms of one certify batch in the synthesis from 512^2 up, whatever
implements it: the ``synth`` stage less the ``pre`` stage."""


def read(rec):
    s = rec.get("stages_ms", {})
    if "synth" not in s or "pre" not in s:
        return None
    return s["synth"] - s["pre"]
