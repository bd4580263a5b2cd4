"""The port's surfaces: the JSON batch front-end and solve server
(``cli``) and the C++ embedding API (``cpp/``)."""
