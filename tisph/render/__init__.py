"""Render / export tier: frame exporters, viewers, surface reconstruction.

Replaces the reference's ti.GUI / GGUI interactive render path
(main.py:16-24, main_3d.py:8-46) with headless frame export fed by async
device->host streaming, plus optional matplotlib viewing — explicitly out of
the device hot path (SURVEY.md §2.9.7).
"""
