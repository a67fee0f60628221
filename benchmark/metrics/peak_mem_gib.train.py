"""The card's allocated-memory peak over the untraced window of train steps, GiB."""


def read(rec):
    return None if rec.window_peak_bytes is None else rec.window_peak_bytes / 2**30
