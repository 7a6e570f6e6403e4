"""Binary -> C header embedder (the reference's convert_to_header.py step;
counterpart of `vqvdb_tpu/interop/embed.py`, writing the same header text).

Completes the literal deployment chain checkpoint -> ONNX -> embedded C
arrays: the reference compiles model bytes into its DSO as
`encoder_model_data`/`decoder_model_data` + `_size` symbols consumed by
OnnxBackendFactory (ref: src/backends/onnx/OnnxBackendFactory.cpp:100-104,
python/convert_to_header.py:4-44). `write_embed_header` emits a header with
those exact symbol names from our exported encoder.onnx/decoder.onnx so a
model trained here can be baked into the reference plugin binary.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union


def _c_array(name: str, data: bytes, per_line: int = 12) -> str:
    lines = [f"const unsigned char {name}[] = {{"]
    for i in range(0, len(data), per_line):
        chunk = ", ".join(f"0x{b:02x}" for b in data[i:i + per_line])
        lines.append(f"    {chunk},")
    lines.append("};")
    lines.append(f"const size_t {name}_size = sizeof({name});")
    return "\n".join(lines)


def write_embed_header(out_path: Union[str, Path],
                       arrays: Dict[str, Union[str, Path, bytes]]) -> Path:
    """Write a C header embedding each named binary.

    arrays maps symbol name -> file path or raw bytes, e.g.
    {"encoder_model_data": "onnx/encoder.onnx",
     "decoder_model_data": "onnx/decoder.onnx"}.
    """
    out_path = Path(out_path)
    guard = out_path.name.upper().replace(".", "_").replace("-", "_")
    parts = [
        "// Generated by vqvdb_tpu (interop/embed.py) — model bytes for",
        "// compile-time embedding, reference OnnxBackendFactory contract.",
        f"#ifndef VQVDB_{guard}",
        f"#define VQVDB_{guard}",
        "#include <stddef.h>",
        "",
    ]
    for name, src in arrays.items():
        data = src if isinstance(src, bytes) else Path(src).read_bytes()
        parts.append(_c_array(name, data))
        parts.append("")
    parts.append(f"#endif  // VQVDB_{guard}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text("\n".join(parts))
    return out_path
