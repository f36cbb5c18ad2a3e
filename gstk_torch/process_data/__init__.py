"""Data processing (port of ``gstk_tpu/process_data``): COLMAP models,
depth alignment, the images-to-dataset pipeline, monocular depth, equirect
extraction and Aria capture conversion."""
