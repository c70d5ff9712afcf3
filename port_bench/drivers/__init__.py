"""How a traffic mix drives the program: ``drivers/<driver>.py``, named by
the mix's ``driver`` key, exposes ``Driver``."""


def worst(*values):
    """The largest of ``values`` (numbers or iterables of numbers), NaN
    where any is NaN: a NaN answer must not read as a small gap, as it does
    under ``max``."""
    flat = []
    for v in values:
        if hasattr(v, "__iter__") and not hasattr(v, "item"):
            flat.extend(float(x) for x in v)
        else:
            flat.append(float(v))
    return float("nan") if any(v != v for v in flat) else max(flat)
