from .image_io import (read_flo, read_image, read_pfm, read_stevimg,
                       write_flo, write_image, write_pfm, write_stevimg)
from .exr_io import (read_exr, read_exr_channel, write_exr, is_exr_file,
                     exr_channels)
from .pointcloud_io import (PointCloud, open_point_cloud, save_point_cloud,
                            open_point_cloud_stream,
                            read_las, write_las, read_pcd, write_pcd)

__all__ = ["exr_channels", "is_exr_file", "read_exr", "read_exr_channel",
           "read_flo", "read_image", "read_pfm", "read_stevimg",
           "write_exr", "write_flo", "write_image", "write_pfm",
           "write_stevimg",
           "PointCloud", "open_point_cloud", "save_point_cloud",
           "open_point_cloud_stream",
           "read_las", "write_las", "read_pcd", "write_pcd"]
