"""Device ms a traced scoring call in the backbone: the stream's time between the CUDA events that the program records around each extractor call while a profile is active (the counters extractor_device_us over extractor_timed)."""

from harness import spans

EXTRACTOR_DEVICE_US, EXTRACTOR_TIMED = "extractor_device_us", "extractor_timed"


def read(rec):
    c = spans.counters()
    if not c or not c.get(EXTRACTOR_TIMED):
        return None
    return c.get(EXTRACTOR_DEVICE_US, 0) / c[EXTRACTOR_TIMED] / 1e3
