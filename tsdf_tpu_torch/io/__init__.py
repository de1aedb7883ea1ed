"""Host-side I/O: PNG, PGM, TUM, .tsdf, BlockTSDF, PLY, scene flow and
the MockKinect replay (numpy only; a volume goes to the device its
loader is given)."""

from .png import load_png, save_png
from .pgm import load_pgm, save_pgm, read_nyu_depth_map, read_tum_depth_map
from .depth_image import DepthImage
from .tum import TUMDataLoader
from .tsdf_file import save_tsdf, load_tsdf
from .block_tsdf import load_block_tsdf, save_block_tsdf
from .ply import write_ply
from .convert import freenect2png, pgm2png, freenect_raw11_to_mm
from .sceneflow import (
    MockSceneFlow,
    PDSFMockSceneFlow,
    SRSFMockSceneFlow,
    read_pdflow,
    read_srsf_xml,
)
from .mock_kinect import MockKinect, RGBDDevice

__all__ = [
    "load_png",
    "save_png",
    "load_pgm",
    "save_pgm",
    "read_nyu_depth_map",
    "read_tum_depth_map",
    "DepthImage",
    "TUMDataLoader",
    "save_tsdf",
    "load_tsdf",
    "load_block_tsdf",
    "save_block_tsdf",
    "write_ply",
    "freenect2png",
    "pgm2png",
    "freenect_raw11_to_mm",
    "MockSceneFlow",
    "PDSFMockSceneFlow",
    "SRSFMockSceneFlow",
    "read_pdflow",
    "read_srsf_xml",
    "MockKinect",
    "RGBDDevice",
]
