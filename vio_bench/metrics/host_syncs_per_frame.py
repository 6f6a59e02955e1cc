"""Waits of the host on the device (the program's `host_syncs`
counter) per frame of the window before the traced stretch."""

from vio_bench import record


def read(res):
    fr = record.untraced_frames(res)
    if not fr:
        return None
    return record.counter(res, fr, "host_syncs") / len(fr)
