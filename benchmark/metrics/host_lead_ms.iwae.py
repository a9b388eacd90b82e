"""How far the host runs ahead of the device in IWAE scoring: the median
over the window's batches of each batch's smallest device-marker lead (at
the batch's and each chunk's start; the program's span recorder,
unprofiled)."""

from benchmark.metrics import _recorder


def read(s):
    if s.unit != "iwae":
        return None
    return _recorder.median([x for c in _recorder.iwae_calls()
                             for x in c["unit_leads_ms"].get("eval.batch",
                                                             [])])
