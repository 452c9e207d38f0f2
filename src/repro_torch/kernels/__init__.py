"""Hand-written Hopper kernels of the serving path, their plain versions
(``ref``) and the dispatch between them (``ops``)."""
