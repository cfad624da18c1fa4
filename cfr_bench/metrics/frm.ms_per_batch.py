"""ms of one certify batch in the resize and the face-recognition network:
the ``embed`` stage less the ``synth`` stage."""


def read(rec):
    s = rec.get("stages_ms", {})
    if "embed" not in s or "synth" not in s:
        return None
    return s["embed"] - s["synth"]
