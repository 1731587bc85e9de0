"""Input layer (``io/reader.py``): the step anatomy's ``data_wait`` phase,
the host time a step waited on ``device_prefetch``, mean ms over the
window's observed steps."""


def read(r):
    if not r.phases:
        return None
    return sum(p["data_wait"] for p in r.phases) / len(r.phases)
