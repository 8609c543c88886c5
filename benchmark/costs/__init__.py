"""Operations and bytes, from launch shapes and configurations: one file
per kernel (its roofline bound) and per model (its products' FLOPs)."""
