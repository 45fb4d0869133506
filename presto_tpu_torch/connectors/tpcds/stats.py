"""TPC-DS connector statistics: per-column distinct-count upper bounds.

The port's own copy of presto_tpu/connectors/tpcds/stats.py. Domains
follow generator.py exactly, so every value is a true upper bound.
Fact-table foreign keys resolve by suffix rule (column endswith
`<dim>_sk`); dimension attributes come from the generator's vocabulary
lists. The connector has no value-range statistics, so its scans stage
at their logical widths (plan/widths.py).
"""

from __future__ import annotations

from typing import Optional

from . import generator as G
from .generator import table_row_count

# *_sk suffix -> referenced dimension (fact FKs and dim self-keys)
_SK_DIMS = [
    ("item_sk", "item"),
    ("customer_sk", "customer"),
    ("cdemo_sk", "customer_demographics"),
    ("hdemo_sk", "household_demographics"),
    ("addr_sk", "customer_address"),
    ("store_sk", "store"),
    ("promo_sk", "promotion"),
    ("call_center_sk", "call_center"),
    ("catalog_page_sk", "catalog_page"),
    ("ship_mode_sk", "ship_mode"),
    ("warehouse_sk", "warehouse"),
    ("web_page_sk", "web_page"),
    ("web_site_sk", "web_site"),
    ("reason_sk", "reason"),
    ("income_band_sk", "income_band"),
    ("demo_sk", "customer_demographics"),  # cd_demo_sk (after cdemo/hdemo)
]

# sold span in days (generator: _SOLD_LO.._SOLD_HI), plus ship lag 150
# and return lag 90 for the derived date keys
_SOLD_DAYS = G._SOLD_HI - G._SOLD_LO + 1


def _vocab(lst) -> int:
    return len(lst)


# dimension-attribute domains (generator.py vocab lists / value ranges)
def _attr_table():
    return {
        # date_dim: days 0..73048 since 1900-01-01
        ("date_dim", "d_year"): 201, ("date_dim", "d_fy_year"): 201,
        ("date_dim", "d_moy"): 12, ("date_dim", "d_dom"): 31,
        ("date_dim", "d_qoy"): 4, ("date_dim", "d_dow"): 7,
        ("date_dim", "d_day_name"): 7,
        ("date_dim", "d_month_seq"): 201 * 12,
        ("date_dim", "d_week_seq"): G._DATE_ROWS // 7 + 1,
        ("date_dim", "d_fy_week_seq"): G._DATE_ROWS // 7 + 1,
        ("date_dim", "d_quarter_seq"): 201 * 4,
        ("date_dim", "d_fy_quarter_seq"): 201 * 4,
        ("date_dim", "d_quarter_name"): 201 * 4,
        ("date_dim", "d_holiday"): 2, ("date_dim", "d_weekend"): 2,
        ("date_dim", "d_following_holiday"): 2,
        ("date_dim", "d_current_day"): 1, ("date_dim", "d_current_week"): 1,
        ("date_dim", "d_current_month"): 1,
        ("date_dim", "d_current_quarter"): 1,
        ("date_dim", "d_current_year"): 1,
        ("time_dim", "t_hour"): 24, ("time_dim", "t_minute"): 60,
        ("time_dim", "t_second"): 60, ("time_dim", "t_am_pm"): 2,
        ("time_dim", "t_shift"): 3, ("time_dim", "t_sub_shift"): 4,
        ("time_dim", "t_meal_time"): 4,
        ("item", "i_brand_id"): 9016, ("item", "i_brand"): 9016,
        ("item", "i_class_id"): 16, ("item", "i_class"): 16,
        ("item", "i_category_id"): 10,
        ("item", "i_category"): _vocab(G._CATEGORIES),
        ("item", "i_manufact_id"): 1000, ("item", "i_manufact"): 1000,
        ("item", "i_size"): _vocab(G._SIZES),
        ("item", "i_color"): _vocab(G._COLORS),
        ("item", "i_units"): _vocab(G._UNITS),
        ("item", "i_container"): _vocab(G._CONTAINERS),
        ("item", "i_manager_id"): 100,
        ("item", "i_current_price"): 9901,
        ("customer", "c_salutation"): 6,
        ("customer", "c_first_name"): _vocab(G._FIRST_NAMES),
        ("customer", "c_last_name"): _vocab(G._LAST_NAMES),
        ("customer", "c_preferred_cust_flag"): 2,
        ("customer", "c_birth_day"): 28,
        ("customer", "c_birth_month"): 12,
        ("customer", "c_birth_year"): 69,
        ("customer", "c_birth_country"): 8,
        ("customer_address", "ca_street_name"): _vocab(G._STREET_NAMES),
        ("customer_address", "ca_street_type"): _vocab(G._STREET_TYPES),
        ("customer_address", "ca_city"): _vocab(G._CITIES),
        ("customer_address", "ca_county"): _vocab(G._COUNTIES),
        ("customer_address", "ca_state"): _vocab(G._STATES),
        ("customer_address", "ca_country"): 1,
        ("customer_address", "ca_gmt_offset"): 4,
        ("customer_address", "ca_location_type"): 3,
        ("customer_address", "ca_suite_number"): 100,
        ("customer_address", "ca_street_number"): 999,
        ("customer_demographics", "cd_gender"): _vocab(G._GENDERS),
        ("customer_demographics", "cd_marital_status"): _vocab(G._MARITAL),
        ("customer_demographics", "cd_education_status"): _vocab(G._EDUCATION),
        ("customer_demographics", "cd_purchase_estimate"): 20,
        ("customer_demographics", "cd_credit_rating"): _vocab(G._CREDIT),
        ("customer_demographics", "cd_dep_count"): 7,
        ("customer_demographics", "cd_dep_employed_count"): 7,
        ("customer_demographics", "cd_dep_college_count"): 7,
        ("household_demographics", "hd_buy_potential"):
            _vocab(G._BUY_POTENTIAL),
        ("household_demographics", "hd_dep_count"): 10,
        ("household_demographics", "hd_vehicle_count"): 5,
        ("income_band", "ib_lower_bound"): 20,
        ("income_band", "ib_upper_bound"): 20,
        ("store", "s_state"): _vocab(G._STATES),
        ("store", "s_county"): _vocab(G._COUNTIES),
        ("store", "s_city"): _vocab(G._CITIES),
        ("promotion", "p_channel_email"): 2,
        ("promotion", "p_channel_tv"): 2,
        ("promotion", "p_channel_event"): 2,
        ("promotion", "p_channel_dmail"): 2,
        ("ship_mode", "sm_type"): _vocab(G._SM_TYPES),
        ("ship_mode", "sm_code"): _vocab(G._SM_CODES),
        ("ship_mode", "sm_carrier"): _vocab(G._SM_CARRIERS),
    }


_ATTRS = None

# dimension primary keys: domain is the table's own row count (these
# must resolve BEFORE the suffix rules -- e.g. date_dim.d_date_sk spans
# all 73049 rows, far beyond the fact tables' sold-date window)
_PKS = {
    ("date_dim", "d_date_sk"), ("time_dim", "t_time_sk"),
    ("item", "i_item_sk"), ("customer", "c_customer_sk"),
    ("customer_address", "ca_address_sk"),
    ("customer_demographics", "cd_demo_sk"),
    ("household_demographics", "hd_demo_sk"),
    ("income_band", "ib_income_band_sk"), ("store", "s_store_sk"),
    ("warehouse", "w_warehouse_sk"), ("ship_mode", "sm_ship_mode_sk"),
    ("reason", "r_reason_sk"), ("promotion", "p_promo_sk"),
    ("call_center", "cc_call_center_sk"),
    ("catalog_page", "cp_catalog_page_sk"),
    ("web_site", "web_site_sk"), ("web_page", "wp_web_page_sk"),
}


def column_distinct_count(table: str, column: str,
                          sf: float) -> Optional[int]:
    global _ATTRS
    if _ATTRS is None:
        _ATTRS = _attr_table()
    hit = _ATTRS.get((table, column))
    if hit is not None:
        return hit
    if (table, column) in _PKS:
        return table_row_count(table, sf)
    # fact quantity columns (uniform 1..100; returns bounded by parent)
    if column.endswith("quantity_on_hand"):
        return 1001
    if column.endswith("_quantity"):
        return 101
    # date keys: sold span + ship lag (150) + return lag (90)
    if column.endswith("date_sk") or column == "inv_date_sk":
        return _SOLD_DAYS + 150 + 90 + 2
    if column.endswith("time_sk"):
        return 79_200 - 28_800 + 1
    if column == "ss_ticket_number":
        return table_row_count("store_sales", sf) // 8 + 1
    if column == "sr_ticket_number":
        return table_row_count("store_sales", sf) // 8 + 1
    if column in ("cs_order_number", "cr_order_number"):
        return table_row_count("catalog_sales", sf) // 10 + 1
    if column in ("ws_order_number", "wr_order_number"):
        return table_row_count("web_sales", sf) // 12 + 1
    # surrogate keys, by suffix (longest-match)
    if column.endswith("_sk"):
        for suffix, dim in _SK_DIMS:
            if column.endswith(suffix):
                return table_row_count(dim, sf)
    return None
