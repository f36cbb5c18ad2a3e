"""Data processing: COLMAP models and depth alignment (port of
``gstk_tpu/process_data``)."""
