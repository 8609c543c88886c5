"""The plain reference the benchmark's check compares the port with:
float32 PyTorch (TF32 off), written from the published model (DINO's
``vision_transformer.py``, ``main_dino.py``) and the product's
segmentation head.  It imports nothing of the port and takes nothing the
port made: the benchmark hands both sides the same seeded weights and
inputs.  ``lowp.py`` is the lower-precision control."""
