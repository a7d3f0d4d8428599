from .dataparser import ImageSet, PointCloud, DataParserOutputs, DataParser
from .blender import BlenderDataParserConfig
from .colmap import ColmapDataParserConfig
