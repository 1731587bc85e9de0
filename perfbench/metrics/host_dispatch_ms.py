"""Train step layer (``models/train.py``): the step anatomy's ``host``
phase, the host time one call of the step takes to dispatch its work,
mean ms over the window's observed steps."""


def read(r):
    if not r.phases:
        return None
    return sum(p["host"] for p in r.phases) / len(r.phases)
