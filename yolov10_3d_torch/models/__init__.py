"""Models outside the YOLO YAML family: the DINOv2 depth teacher (``dino.py``)."""
