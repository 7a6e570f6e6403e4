"""Host ms a frame spends reading its file (format/vqvdb.py; decompress's host_seconds.read_frames)."""

from portbench import readers


def read(rec):
    return readers.host_ms_per_frame(rec, "decode", "read_frames")
