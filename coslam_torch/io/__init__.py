"""I/O (the port of ``coslam_tpu/io``): the synthetic room and its renders
(``synthetic``), trajectory evaluation (``ate``), input and calibration
files (``calib``), the native frame loader (``loader``), result export in
the reference's format (``export``), checkpoints (``checkpoint``) and
figures (``viz``, which needs matplotlib)."""

from coslam_torch.io.calib import (InputSpec, parse_input_file,  # noqa: F401
                                   read_calib_file, write_calib_file)
from coslam_torch.io.checkpoint import (load_checkpoint,  # noqa: F401
                                        save_checkpoint)
from coslam_torch.io.export import export_results, load_campose  # noqa: F401
from coslam_torch.io.loader import (MODE_PGM, MODE_RAW,  # noqa: F401
                                    FrameLoader, convert_video_to_raw,
                                    write_raw_sequence)
from coslam_torch.io.synthetic import (apply_distortion_warp,  # noqa: F401
                                       render_batch, render_sequence)
