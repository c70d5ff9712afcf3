"""Small mixes of each cell, for runs on the CPU."""
SERVE = {"rounds": 1, "round": [
    {"count": 2, "polymers": [{"kind": "rna", "chains": [1, 2],
                               "length": {"dist": "uniform", "lo": 40, "hi": 60}}]},
    {"count": 1, "polymers": [
        {"kind": "protein", "chains": [1, 1], "length": {"dist": "uniform", "lo": 30, "hi": 40}},
        {"kind": "dna", "chains": [2, 2], "each": True,
         "length": {"dist": "uniform", "lo": 10, "hi": 12}}]}],
    "check": {"tokens": 200, "requests": 3}, "profile_seconds": 0.5}
TRAIN = {"length": {"dist": "lognormal", "median": 60, "sigma": 0.3, "lo": 40, "hi": 100},
         "batch_tokens": 200, "batches": 3, "profile_seconds": 0.5}


def mix(workload):
    return TRAIN if workload == "design.train" else SERVE
