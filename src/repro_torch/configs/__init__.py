"""Model configurations of the port (``dlrm_recross``)."""
