"""Logical-axis sharding: the rule table (``logical``) and the mesh
context model code reads (``context``)."""
