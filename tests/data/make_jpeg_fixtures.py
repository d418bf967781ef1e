"""Write the JPEG fixtures of tests/test_torch_data.py and chip_smoke.py with
PIL, and record beside them the SHA-256 of the RGB pixels PIL decodes from
each file (``jpeg_fixtures.json``).

    python tests/data/make_jpeg_fixtures.py

The files cover the layouts the port's decoder reads: 4:2:0 with a restart
marker after every MCU at a size that is no MCU multiple, 4:2:2, 4:4:4, and
a 1280x1024 4:2:0 frame at SCARED's native size.  The digests are of PIL's
decode on the machine that ran this script; the tests hold the port's
decoder to them.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
# name -> (width, height, PIL subsampling 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0,
#          quality, restart_marker_blocks or None)
FIXTURES = {
    "jpeg_420_rst_37x23.jpg": (37, 23, 2, 90, 1),
    "jpeg_422_64x48.jpg": (64, 48, 1, 85, None),
    "jpeg_444_33x17.jpg": (33, 17, 0, 95, None),
    "jpeg_420_1280x1024.jpg": (1280, 1024, 2, 75, None),
}


def frame(w: int, h: int, seed: int) -> np.ndarray:
    """A smooth endoscope-like frame: a lit disc of tissue colours with
    soft texture and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(w, h)
    r = np.hypot(x - 0.5 * w / max(w, h), y - 0.5 * h / max(w, h))
    light = np.clip(1.2 - 1.6 * r, 0.1, 1.0)
    tex = 0.5 + 0.25 * np.sin(23 * x + 3 * np.sin(17 * y)) * np.cos(19 * y)
    base = np.stack([200 * light, (60 + 80 * tex) * light,
                     (50 + 60 * tex) * light], -1)
    base += rng.normal(0.0, 2.0, base.shape)
    return np.clip(base, 0, 255).astype(np.uint8)


def pixels_sha256(path: Path) -> str:
    with Image.open(path) as im:
        return hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()
                              ).hexdigest()


def main():
    record = {}
    for i, (name, (w, h, ss, q, rst)) in enumerate(FIXTURES.items()):
        kw = dict(quality=q, subsampling=ss)
        if rst:
            kw["restart_marker_blocks"] = rst
        Image.fromarray(frame(w, h, i)).save(HERE / name, "JPEG", **kw)
        record[name] = dict(width=w, height=h, subsampling=ss, quality=q,
                            restart_marker_blocks=rst,
                            sha256=pixels_sha256(HERE / name))
    (HERE / "jpeg_fixtures.json").write_text(json.dumps(record, indent=1)
                                              + "\n")


if __name__ == "__main__":
    main()
