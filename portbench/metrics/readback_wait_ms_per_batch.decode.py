"""Host ms the caller is held a decode batch until its results are back from the card (runtime/codec.py _collect, its device/readback_wait stage)."""


def read(rec):
    st = rec.stages.get("device/readback_wait")
    if rec.direction != "decode" or not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]
