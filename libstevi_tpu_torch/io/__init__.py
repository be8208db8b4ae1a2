from .image_io import (read_flo, read_image, read_pfm, read_stevimg,
                       write_flo, write_image, write_pfm, write_stevimg)
from .exr_io import read_exr, write_exr

__all__ = ["read_exr", "read_flo", "read_image", "read_pfm", "read_stevimg",
           "write_exr", "write_flo", "write_image", "write_pfm",
           "write_stevimg"]
