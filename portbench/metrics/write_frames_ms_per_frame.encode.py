"""Host ms a frame spends writing its file (format/vqvdb.py; compress's host_seconds.write_frames)."""

from portbench import readers


def read(rec):
    return readers.host_ms_per_frame(rec, "encode", "write_frames")
