from .image_io import read_image, read_stevimg, write_image, write_stevimg

__all__ = ["read_image", "read_stevimg", "write_image", "write_stevimg"]
