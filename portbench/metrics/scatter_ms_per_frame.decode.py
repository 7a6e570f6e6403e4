"""Host ms a frame spends allocating decompress's output grid and copying each batch's rows and origins into it (runtime/codec.py decompress, its host/scatter stage)."""


def read(rec):
    st = rec.stages.get("host/scatter")
    if rec.direction != "decode" or not st or not rec.frames:
        return None
    return 1e3 * st["total_s"] / rec.frames
