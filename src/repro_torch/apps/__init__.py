"""Applications of the encoded MAC beyond the LM stack (port of
``repro/apps``): the paper's conv-net image classifier and the experiments
of its tables and figures."""
