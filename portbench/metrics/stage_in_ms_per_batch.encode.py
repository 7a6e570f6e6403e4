"""Host ms the codec's pipeline spends copying an encode batch into its pinned input buffer (runtime/codec.py _pipelined, its host/stage_in stage)."""


def read(rec):
    st = rec.stages.get("host/stage_in")
    if rec.direction != "encode" or not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]
