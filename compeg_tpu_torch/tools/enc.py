"""Encode an image file to a baseline restart-interval JPEG with the port's
encoder.

The counterpart of examples/enc.py (the analogue of the reference's
``examples/enc.rs``: PNG -> baseline JPEG with a chosen restart interval,
used to produce test inputs), with the sampling mode selectable.

    python -m compeg_tpu_torch.tools.enc input.png output.jpg --sampling 422 --ri 1 -q 90

Reading the input image needs Pillow, as does ``--libjpeg``.
"""

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument(
        "--sampling", default="422",
        choices=["444", "422", "420", "440", "411", "gray"],
    )
    ap.add_argument("--ri", type=int, default=1,
                    help="restart interval in MCUs (0 = none)")
    ap.add_argument("-q", "--quality", type=int, default=90)
    ap.add_argument(
        "--libjpeg",
        action="store_true",
        help="encode with libjpeg (Pillow) instead of the built-in encoder",
    )
    args = ap.parse_args(argv)

    from PIL import Image

    img = np.asarray(Image.open(args.input).convert("RGB"))
    if args.libjpeg:
        subs = {"444": "4:4:4", "422": "4:2:2", "420": "4:2:0"}
        if args.sampling not in subs:
            ap.error(f"libjpeg cannot encode {args.sampling}; "
                     "use the built-in encoder")
        Image.fromarray(img).save(
            args.output,
            "JPEG",
            quality=args.quality,
            subsampling=subs[args.sampling],
            restart_marker_blocks=max(args.ri, 0) or None,
        )
    else:
        from compeg_tpu_torch import encoder

        data = encoder.encode(
            img,
            sampling=args.sampling,
            quality=args.quality,
            restart_interval_mcus=args.ri or None,
        )
        with open(args.output, "wb") as f:
            f.write(data)
    print(f"wrote {args.output} ({os.path.getsize(args.output)} bytes)")


if __name__ == "__main__":
    main()
