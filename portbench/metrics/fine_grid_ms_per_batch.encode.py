"""Device ms a batch of the reference encoders' 8^3 stage (models/vqvae.py _reference_pre: the pre conv, GroupNorm, relu and the pre residual block), the codec's device/encode_fine stage: two CUDA events around it on the step's stream, recorded only while the run is traced."""


def read(rec):
    st = rec.stages.get("device/encode_fine")
    if rec.direction != "encode" or not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]
