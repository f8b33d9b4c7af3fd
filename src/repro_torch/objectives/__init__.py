"""Objectives of the port: orthonormal fair classification and DRO
(``fair``), robust PCA on the Grassmann manifold (``robust_pca``), and the
group-DRO language-model objective (``lm``)."""
